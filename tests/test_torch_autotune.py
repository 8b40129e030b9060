"""The port's autotuner switches against the JAX package's `choose`.

`REPRO_AUTOTUNE=0` takes the static choice for a cell above
`MIN_MEASURE_ELEMS` without measuring; `REPRO_AUTOTUNE_TABLE` names a
table file, in `benchmarks/kernel_bench.py`'s layout or with the bare
mapping under `autotune_table`, read once; a missing or unreadable file,
or one without `autotune_table`, is ignored. Each case runs both
packages' `choose` under the same environment and holds the port's
algorithm and source to the JAX package's. Neither package measures in
any case here: a measurement would be the only way they could differ.
"""

import json
import os

import jax.numpy as jnp
import pytest
import torch

from repro.kernels import autotune as jtune
from repro_torch.kernels import autotune

#: above MIN_MEASURE_ELEMS (4 x 8192 = 2^15 elements).
BIG = (4, 8192)
SMALL = (2, 16)

ENVS = (autotune.FORCE_ENV, autotune.TABLE_ENV, autotune.MEASURE_ENV)


@pytest.fixture(autouse=True)
def _fresh_state():
    saved = {k: os.environ.pop(k, None) for k in ENVS}
    autotune.reset()
    jtune.reset()
    yield
    autotune.reset()
    jtune.reset()
    for k, v in saved.items():
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v


def _both(shape, env, device="cpu"):
    """(port choice, JAX choice) for one int32 kv cell under ``env``."""
    os.environ.update(env)
    port = autotune.choose(*shape, torch.int32, device=device)
    ref = jtune.choose(*shape, jnp.int32, interpret=True)
    return port, ref


def _keys(shape, device="cpu"):
    return (autotune.cell_key(*shape, torch.int32, True, device),
            jtune.cell_key(*shape, jnp.int32, True, True))


def test_the_two_packages_name_their_switches_alike():
    assert (autotune.TABLE_ENV, autotune.MEASURE_ENV) == (
        jtune.TABLE_ENV, jtune.MEASURE_ENV)
    assert autotune.MIN_MEASURE_ELEMS == jtune.MIN_MEASURE_ELEMS
    port_key, jax_key = _keys(BIG)
    assert port_key.endswith("|cpu") and jax_key.endswith("|cpu|interp")
    assert autotune.cell_key(*BIG, torch.int32, True, "cuda").endswith(
        "|cuda")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_static_switch_takes_the_plain_sort_without_measuring(device):
    port, ref = _both(BIG, {autotune.MEASURE_ENV: "0"}, device=device)
    assert (port.algo, port.source) == (ref.algo, ref.source) == (
        "oracle", "static")
    assert not autotune.MEASUREMENTS and not jtune.MEASUREMENTS
    again = autotune.choose(*BIG, torch.int32, device=device)
    assert (again.algo, again.source) == ("oracle", "cached")
    assert not autotune.MEASUREMENTS


LAYOUTS = {
    "bench": lambda e: {"results": {"autotune_table": {"entries": e}}},
    "no_results": lambda e: {"autotune_table": {"entries": e}},
    "bare": lambda e: {"results": {"autotune_table": e}},
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("algo", ["bitonic", "radix"])
def test_table_file_gives_the_table_choice(tmp_path, layout, algo):
    port_key, jax_key = _keys(BIG)
    entries = {port_key: {"algo": algo, "source": "measured"},
               jax_key: algo}
    doc = LAYOUTS[layout](entries)
    path = tmp_path / "table.json"
    path.write_text(json.dumps(doc))
    port, ref = _both(BIG, {autotune.TABLE_ENV: str(path)})
    assert (port.algo, port.source) == (ref.algo, ref.source) == (
        algo, "table")
    assert not autotune.MEASUREMENTS and not jtune.MEASUREMENTS
    # the file is read once: a later edit is not seen by this process.
    path.write_text(json.dumps(LAYOUTS["bare"]({port_key: "oracle"})))
    assert autotune.choose(*BIG, torch.int32, device="cpu").algo == algo


def test_table_beats_the_static_switch(tmp_path):
    port_key, jax_key = _keys(BIG)
    path = tmp_path / "table.json"
    path.write_text(json.dumps(LAYOUTS["bare"]({port_key: "radix",
                                                jax_key: "radix"})))
    port, ref = _both(BIG, {autotune.TABLE_ENV: str(path),
                            autotune.MEASURE_ENV: "0"})
    assert (port.algo, port.source) == (ref.algo, ref.source) == (
        "radix", "table")


def test_table_keys_of_the_other_package_never_match(tmp_path):
    port_key, jax_key = _keys(BIG)
    path = tmp_path / "table.json"
    path.write_text(json.dumps(LAYOUTS["bare"]({jax_key: "bitonic"})))
    port, ref = _both(BIG, {autotune.TABLE_ENV: str(path),
                            autotune.MEASURE_ENV: "0"})
    assert (ref.algo, ref.source) == ("bitonic", "table")
    assert (port.algo, port.source) == ("oracle", "static")


@pytest.mark.parametrize("content", [None, "{not json", "[1, 2",
                                     json.dumps({"results": []})[:-3],
                                     json.dumps({"kv|int32|4x8192|cpu":
                                                 "radix"})])
@pytest.mark.parametrize("shape", [BIG, SMALL])
def test_missing_or_unreadable_table_is_ignored(tmp_path, content, shape):
    path = tmp_path / "table.json"
    if content is not None:
        path.write_text(content)
    env = {autotune.TABLE_ENV: str(path)}
    if shape == BIG:
        env[autotune.MEASURE_ENV] = "0"
    port, ref = _both(shape, env)
    assert (port.algo, port.source) == (ref.algo, ref.source) == (
        "oracle", "static")
    assert not autotune.MEASUREMENTS and not jtune.MEASUREMENTS


def test_force_still_wins_over_table_and_switch(tmp_path):
    port_key, jax_key = _keys(BIG)
    path = tmp_path / "table.json"
    path.write_text(json.dumps(LAYOUTS["bare"]({port_key: "radix",
                                                jax_key: "radix"})))
    port, ref = _both(BIG, {autotune.TABLE_ENV: str(path),
                            autotune.MEASURE_ENV: "0",
                            autotune.FORCE_ENV: "bitonic"})
    assert (port.algo, port.source) == (ref.algo, ref.source) == (
        "bitonic", "forced")


def test_reset_reads_the_table_again(tmp_path):
    port_key, _ = _keys(BIG)
    path = tmp_path / "table.json"
    path.write_text(json.dumps(LAYOUTS["bare"]({port_key: "bitonic"})))
    os.environ[autotune.TABLE_ENV] = str(path)
    assert autotune.choose(*BIG, torch.int32, device="cpu").algo == "bitonic"
    path.write_text(json.dumps(LAYOUTS["bare"]({port_key: "radix"})))
    autotune.reset()
    assert autotune.choose(*BIG, torch.int32, device="cpu").algo == "radix"
