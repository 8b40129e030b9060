"""The port's data pipeline against the JAX package's, on the CPU: the
same synthetic tokens to the bit, the same Sector slices, the same
batches from ``SectorDataPipeline`` (one ``make_sector`` deployment per
package under ``tmp_path``), and tests/test_train.py's locality and
failover test on the port. Every comparison is exact."""

import numpy as np
import pytest

from repro.data import SectorDataPipeline as JaxPipeline
from repro.data import synthetic_tokens as jax_synthetic_tokens
from repro.data import upload_token_dataset as jax_upload
from repro.launch.train import make_sector as jax_make_sector
from repro_torch.data import (SectorDataPipeline, synthetic_tokens,
                              upload_token_dataset)
from repro_torch.launch.train import make_sector


@pytest.mark.parametrize("n, vocab, seed", [(1, 5, 0), (1000, 256, 0),
                                            (60_000, 32000, 0),
                                            (12_345, 151936, 7)])
def test_synthetic_tokens_equal_the_jax_packages(n, vocab, seed):
    got = synthetic_tokens(n, vocab, seed)
    want = jax_synthetic_tokens(n, vocab, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_hosts, host_id, slices", [(1, 0, 8), (2, 1, 4),
                                                        (3, 2, 5)])
def test_pipeline_batches_equal_the_jax_packages(tmp_path, num_hosts,
                                                 host_id, slices):
    toks = synthetic_tokens(50_000, 512)
    out = []
    for tag, sector, upload, pipeline in (
            ("port", make_sector, upload_token_dataset, SectorDataPipeline),
            ("jax", jax_make_sector, jax_upload, JaxPipeline)):
        master, client, daemon = sector(str(tmp_path / tag))
        metas = upload(client, "/corpus/t", toks, num_slices=slices)
        daemon.run_until_stable()
        pipe = pipeline(master, client, "/corpus/t", batch=4, seq_len=33,
                        host_id=host_id, num_hosts=num_hosts, seed=3,
                        segment_records=1 << 12)
        out.append(([(m.path, m.md5) for m in metas],
                    [s.file_path for s in pipe.my_segments],
                    [b for _ in range(2) for b in pipe]))
    (pm, ps, pb), (jm, js, jb) = out
    assert pm == jm and ps == js
    assert len(pb) == len(jb) > 0
    for a, b in zip(pb, jb):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_pipeline_locality_and_failover(tmp_path):
    m, c, daemon = make_sector(str(tmp_path))
    toks = synthetic_tokens(30_000, 256)
    upload_token_dataset(c, "/corpus/f", toks, num_slices=4)
    daemon.run_until_stable()
    pipe = SectorDataPipeline(m, c, "/corpus/f", batch=4, seq_len=32,
                              host_id=0, num_hosts=2)
    b0 = next(iter(pipe))
    assert b0["tokens"].shape == (4, 32)
    # tokens/labels are shifted views of the same stream
    np.testing.assert_array_equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    # kill a slave: the pipeline keeps reading via replicas
    victim = list(m.slaves)[0]
    m.slaves[victim].kill()
    assert sum(1 for _ in pipe) > 0
