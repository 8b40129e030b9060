"""The port's serving engine on the rest of the model zoo (MLA, xLSTM,
Mamba2 + shared attention, enc-dec, VLM), on the CPU, against the JAX
package's ``ServeEngine`` on the same weights.

As in ``tests/test_torch_serve.py``, the JAX engine's decode step (and,
for whisper, the encoder it runs at each refill) is compiled with XLA's
excess precision off, so every op rounds as the program names it, as the
port's does; the token streams are then held equal whole, request by
request. Five requests through two slots make slots refill, so the
streams also hold the engine's two facts about recurrent states: a
prompt fed token by token through the full-batch decode gives every
other slot a phantom step with token 0, which a Mamba2/mLSTM/sLSTM state
keeps; and a refilled slot's every float leaf is reset to 0, sLSTM's
``n`` (initially 1) included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build as jax_build
from repro.models import encdec as jencdec
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_main
from repro_torch.models import build
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

NO_EXCESS = {"xla_allow_excess_precision": False}
ZOO = ("minicpm3_4b", "xlstm_125m", "zamba2_1_2b", "whisper_small",
       "internvl2_1b")


def _traffic(cfg, n=5):
    """The launcher's draw: a prompt, then (audio) its frames."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(3, 8)))
        frames = (rng.standard_normal((cfg.enc_seq, cfg.d_model))
                  .astype(np.float32) if cfg.family == "audio" else None)
        out.append((prompt.astype(np.int32), frames))
    return out


@pytest.mark.parametrize("arch", ZOO)
def test_engine_token_streams_match_the_jax_engine(arch, monkeypatch):
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jeng = JServeEngine(jmodel, jparams, batch_slots=2, max_len=32)
    batch = {"tokens": jnp.zeros((2, 1), jnp.int32),
             "pos": jnp.zeros((2, 1), jnp.int32)}
    if jcfg.family == "audio":
        batch["enc_out"] = jeng.enc_out
        frames = jnp.zeros((1, jcfg.enc_seq, jcfg.d_model), jnp.bfloat16)
        encode = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f)).lower(
            jparams, frames).compile(NO_EXCESS)
        monkeypatch.setattr(jencdec, "encode", lambda p, c, f: encode(p, f))
    jeng._decode = jax.jit(jmodel.decode_step).lower(
        jparams, jeng.caches, batch).compile(NO_EXCESS)
    eng = ServeEngine(build(cfg), params, batch_slots=2, max_len=32)
    traffic = _traffic(cfg)
    for i, (p, f) in enumerate(traffic):
        jeng.submit(JRequest(i, p, max_new_tokens=6, frames=f))
        eng.submit(Request(i, p, max_new_tokens=6, frames=f))
    want = {r.req_id: r.out_tokens for r in jeng.run_to_completion()}
    got = {r.req_id: r.out_tokens for r in eng.run_to_completion()}
    assert sorted(got) == sorted(want) == list(range(len(traffic)))
    for i in want:
        assert got[i] == want[i], (arch, i, got[i], want[i])


@pytest.mark.parametrize("arch,phantom", [
    ("xlstm_125m", True), ("zamba2_1_2b", True), ("minicpm3_4b", False),
    ("internvl2_1b", False)])
def test_refills_give_other_slots_a_phantom_recurrent_step(arch, phantom):
    """The reference's fact, held in the port: on a recurrent stack a
    slot's tokens depend on when the other slot refills. A request alone
    in slot 0, and the same request while slot 1 refills three times
    (each refill feeds a prompt through the full-batch decode): the
    recurrent stacks give other tokens (the phantom steps stay in slot
    0's state), the attention-only stacks the same ones (the phantom
    entries are overwritten)."""
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    long_p = np.array([5, 17, 3, 99, 42, 7], np.int32)
    runs = []
    for others in (0, 3):
        eng = ServeEngine(model, params, batch_slots=2, max_len=32)
        eng.submit(Request(0, long_p, max_new_tokens=8))
        for i in range(1, others + 1):
            eng.submit(Request(i, np.arange(1, 7, dtype=np.int32) * i,
                               max_new_tokens=2))
        done = {r.req_id: r.out_tokens for r in eng.run_to_completion()}
        runs.append(done[0])
    assert (runs[0] != runs[1]) == phantom, runs


def test_list_caches_reset_a_slot_as_the_jax_engine_does():
    """A heterogeneous stack's caches are a list of per-layer dicts; the
    batch axis of every leaf is found structurally, and a reset slot's
    rows are 0 (positions -1), sLSTM's ``n`` included."""
    cfg = get_smoke_config("xlstm_125m")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(model, params, batch_slots=3, max_len=16)
    assert isinstance(eng.caches, list) and len(eng.caches) == cfg.num_layers
    assert eng._batch_axes[0] == {"C": 0, "n": 0, "m": 0, "conv": 0}
    assert eng._batch_axes[2] == {"c": 0, "n": 0, "h": 0, "m": 0}
    assert (eng.caches[2]["n"] == 1).all()
    eng._reset_slot_cache(1)
    for cache in eng.caches:
        for leaf in cache.values():
            assert not leaf[1].any()
    assert (eng.caches[2]["n"][0] == 1).all()
    zamba = get_smoke_config("zamba2_1_2b")
    zm = build(zamba)
    zeng = ServeEngine(zm, zm.init(torch.Generator().manual_seed(0), "cpu"),
                       batch_slots=2, max_len=16)
    # 4 mamba layers, then the shared block's 2 application points
    assert len(zeng.caches) == zamba.num_layers + 2
    assert zeng._batch_axes[-1] == {"k": 0, "v": 0, "pos": 0}
    zeng._reset_slot_cache(0)
    assert (zeng.caches[-1]["pos"][0] == -1).all()


def test_enc_dec_engine_encodes_frames_into_the_slot_memory():
    """whisper: a refill encodes the request's frames into its slot's row
    of ``enc_out``; the decode batch carries the whole memory."""
    from repro_torch.models import encdec
    cfg = get_smoke_config("whisper_small")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(model, params, batch_slots=2, max_len=32)
    assert eng.enc_out.shape == (2, cfg.enc_seq, cfg.d_model)
    (p, f), = _traffic(cfg, 1)
    eng.submit(Request(0, p, max_new_tokens=3, frames=f))
    eng.step()
    with torch.inference_mode():
        want = encdec.encode(params, cfg, torch.from_numpy(f).bfloat16()[None])
    assert torch.equal(eng.enc_out[0], want[0])
    assert not eng.enc_out[1].any()
    assert len(eng.run_to_completion()[0].out_tokens) == 3


@pytest.mark.parametrize("arch", ["whisper_small", "zamba2_1_2b"])
def test_launcher_serves_every_family_on_the_cpu(arch, capsys):
    serve_main.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--requests", "3", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert out.startswith("served 3 requests, 9 tokens")
