"""The port's decoder LM stack against the JAX package, on the CPU.

Both packages get the same numpy inputs; the weights are the JAX
package's ``init`` at ``PRNGKey(0)``, carried across by
``repro_torch.models.convert.params_from_numpy`` (matrix weights in
bfloat16, which every JAX product casts them to first).

The JAX functions are compiled with XLA's "excess precision" off
(:func:`jax_exact`; the grid references of
``tests/test_torch_jax_model_refs.py`` likewise): by default XLA may keep
a bfloat16 intermediate of a compiled function in float32, so the JAX
package's compiled results differ from its own op-by-op results by up to
0.0625 on these logits. With it off every op rounds to the dtype the
program names, as the port does: the port follows the JAX package's ops
and roundings one by one, so on this CPU its results agree to the last
bit but for a bfloat16 ulp here and there (GELU's float32 ``tanh``, the
order of a float32 sum). Tolerances, stated once:

- ``ATOL_MODULE`` 3e-2 on the bfloat16 output of one module (about 4
  bfloat16 ulps at the outputs' magnitude, 1-4);
- ``ATOL_LOGITS`` 5e-2 on float32 logits of the 2-3-layer smoke models;
- ``ATOL_COMPILED`` 0.1 on logits against the JAX package's compiled path
  (its own compiled-vs-op-by-op spread, 0.0625, plus margin);
- exact: top-k ids, drop counts, cache positions, tokens.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import build as jax_build
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch.comm import Ranks
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops as kops, partition
from repro_torch.models import attention, build, layers, moe, transformer
from repro_torch.models.convert import flatten, params_from_numpy

from test_torch_jax_model_refs import (MOE_ARCH, MOE_CASES, PREFILL_ARCH,
                                       PREFILL_CF, PREFILL_EXPERTS,
                                       PREFILL_MAX_LEN, RAISE_CASES,
                                       model_references, moe_input,
                                       prefill_tokens)

ATOL_MODULE = 3e-2
ATOL_LOGITS = 5e-2
ATOL_COMPILED = 0.1
KEY = jax.random.PRNGKey(0)
LM_ARCHS = ("tinyllama_1_1b", "h2o_danube_1_8b", "qwen2_moe_a2_7b",
            "qwen3_moe_30b_a3b")


@pytest.fixture(scope="module")
def grid_ref(tmp_path_factory):
    return model_references(tmp_path_factory)


def f32(a) -> np.ndarray:
    """A JAX array or a torch tensor as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def bf16(a: np.ndarray):
    """The same bfloat16 values for both packages (round to nearest
    even in both)."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def close(got, want, atol, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= atol, f"{what}: max |port - jax| = {err} > {atol}"


def configs(arch, **overrides):
    jc, tc = jax_smoke_config(arch), get_smoke_config(arch)
    if overrides:
        jc = dataclasses.replace(jc, **overrides)
        tc = dataclasses.replace(tc, **overrides)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_params(arch, overrides):
    jc, _ = configs(arch, **dict(overrides))
    params, _ = jax_build(jc).init(KEY)
    return params


def both_params(arch, **overrides):
    """The JAX package's params and the port's model holding them."""
    jc, tc = configs(arch, **overrides)
    jp = _jax_params(arch, tuple(sorted(overrides.items())))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                         "cpu")


#: XLA compiler options under which a compiled function rounds every op
NO_EXCESS = {"xla_allow_excess_precision": False}


def jax_exact(fn, *args):
    """``fn`` compiled for ``args`` with excess precision off (see the
    module docstring); call it with arrays of the same shapes."""
    return jax.jit(fn).lower(*args).compile(NO_EXCESS)


def positions(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


# -- layers -----------------------------------------------------------------------


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    jx, tx = bf16(rng.standard_normal((2, 16, 64)).astype(np.float32) * 3)
    scale = rng.standard_normal(64).astype(np.float32)
    close(layers.rms_norm(tx, torch.from_numpy(scale), 1e-5),
          jlayers.rms_norm(jx, jnp.asarray(scale), 1e-5), ATOL_MODULE)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    jx, tx = bf16(rng.standard_normal((2, 24, 4, 16)).astype(np.float32))
    pos = positions(2, 24) * 7
    close(layers.apply_rope(tx, torch.from_numpy(pos), theta),
          jlayers.apply_rope(jx, jnp.asarray(pos), theta), ATOL_MODULE)
    np.testing.assert_allclose(
        layers.rope_freqs(16, theta).numpy(),
        np.asarray(jlayers.rope_freqs(16, theta)), rtol=1e-6)


def test_silu_and_gelu_round_as_jax_does():
    """The activations round every step to bfloat16 as the JAX package's
    do (a fused ``F.silu`` differs from ``jax.nn.silu`` in about a third
    of bfloat16 results); SiLU to the bit, GELU within one bfloat16 ulp
    (its float32 ``tanh`` is another implementation)."""
    rng = np.random.default_rng(2)
    jx, tx = bf16(rng.standard_normal(1 << 14).astype(np.float32) * 4)
    np.testing.assert_array_equal(f32(layers.silu(tx)),
                                  f32(jax.nn.silu(jx)))
    want = f32(jax.nn.gelu(jx))
    ulp = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7
    assert np.all(np.abs(f32(layers.gelu(tx)) - want) <= ulp)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_apply_matches_jax(gated):
    jp, _ = jlayers.mlp_init(KEY, 64, 160, gated)
    tp = {k: torch.from_numpy(np.asarray(v)).bfloat16() for k, v in jp.items()}
    rng = np.random.default_rng(3)
    jx, tx = bf16(rng.standard_normal((2, 16, 64)).astype(np.float32))
    want = jax_exact(lambda p, x: jlayers.mlp_apply(p, x, gated), jp, jx)(
        jp, jx)
    close(layers.mlp_apply(tp, tx, gated), want, ATOL_MODULE)


def test_embed_lookup_and_lm_logits_mask_the_padded_vocabulary():
    vocab, d = 200, 64
    emb, _ = jlayers.embed_init(KEY, vocab, d)
    assert emb.shape[0] == layers.padded_vocab(vocab) == 256
    temb = torch.from_numpy(np.asarray(emb)).bfloat16()
    tokens = np.random.default_rng(4).integers(0, vocab, (2, 9)).astype(
        np.int32)
    jx = jlayers.embed_lookup(emb, jnp.asarray(tokens))
    tx = layers.embed_lookup(temb, torch.from_numpy(tokens))
    np.testing.assert_array_equal(f32(tx), f32(jx))
    for cap in (0.0, 30.0):
        want = np.asarray(jlayers.lm_logits(emb, jx, cap, vocab))
        got = layers.lm_logits(temb, tx, cap, vocab).numpy()
        close(got[..., :vocab], want[..., :vocab], ATOL_LOGITS)
        np.testing.assert_array_equal(got[..., vocab:], want[..., vocab:])
        assert np.all(got[..., vocab:] == -1e30)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(masked):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4) if masked else None
    want = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    got = layers.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- attention -------------------------------------------------------------------


def _attn_pair(arch):
    jc, tc = configs(arch)
    jp, _ = jattn.attn_init(KEY, jc)
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    tp = {k: v if k.endswith("norm") else v.bfloat16() for k, v in tp.items()}
    return jc, tc, jp, tp


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "h2o_danube_1_8b",
                                  "qwen3_moe_30b_a3b", "granite_34b"])
def test_attn_apply_without_cache_matches_jax(arch):
    """GQA, SWA (window 16 < 24 positions), ``qk_norm`` and one kv head."""
    jc, tc, jp, tp = _attn_pair(arch)
    rng = np.random.default_rng(6)
    jx, tx = bf16(rng.standard_normal((2, 24, jc.d_model)).astype(np.float32))
    pos = positions(2, 24)
    want, _ = jax_exact(lambda p, x, q: jattn.attn_apply(p, x, jc, q), jp, jx,
                        pos)(jp, jx, pos)
    got, cache = attention.attn_apply(tp, tx, tc, torch.from_numpy(pos))
    assert cache is None
    close(got, want, ATOL_MODULE, arch)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen3_moe_30b_a3b",
                                  "granite_34b"])
def test_attn_decode_step_with_cache_matches_jax(arch):
    """A 10-position prefill into a cache of 16, then one decode step."""
    jc, tc, jp, tp = _attn_pair(arch)
    rng = np.random.default_rng(7)
    jx, tx = bf16(rng.standard_normal((2, 11, jc.d_model)).astype(np.float32))
    jcache = jattn.init_cache_gqa(jc, 2, 16)
    tcache = attention.init_cache_gqa(tc, 2, 16)
    pos = positions(2, 11)
    def step(p, x, q, c):
        return jattn.attn_apply(p, x, jc, q, c)

    args = (jp, jx[:, :10], pos[:, :10], jcache)
    _, jcache = jax_exact(step, *args)(*args)
    args = (jp, jx[:, 10:], pos[:, 10:], jcache)
    want, jcache = jax_exact(step, *args)(*args)
    attention.attn_apply(tp, tx[:, :10], tc, torch.from_numpy(pos[:, :10]),
                         tcache)
    got, tcache = attention.attn_apply(tp, tx[:, 10:], tc,
                                       torch.from_numpy(pos[:, 10:]), tcache)
    close(got, want, ATOL_MODULE, arch)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    close(tcache["k"], jcache["k"], ATOL_MODULE, "cache k")
    close(tcache["v"], jcache["v"], ATOL_MODULE, "cache v")


def test_swa_ring_buffer_40_decode_steps_match_jax():
    """h2o-danube smoke, window 16: the cache holds 16 slots, positions
    past the window are overwritten and masked; 40 decode steps."""
    jc, tc, jp, tp = both_params("h2o_danube_1_8b")
    jm, tm = jax_build(jc), build(tc)
    toks = np.random.default_rng(8).integers(0, jc.vocab, (1, 40)).astype(
        np.int32)
    jcache = jm.init_caches(1, 40)
    tcache = tm.init_caches(1, 40, device="cpu")
    assert tcache["k"].shape[2] == jc.window == 16
    errs = []
    decode = None
    for t in range(40):
        b = {"tokens": toks[:, t:t + 1], "pos": np.full((1, 1), t, np.int32)}
        decode = decode or jax_exact(jm.decode_step, jp, jcache, b)
        want, jcache = decode(jp, jcache, b)
        got, tcache = tm.decode_step(tp, tcache, {
            k: torch.from_numpy(v) for k, v in b.items()})
        errs.append(np.max(np.abs(f32(got)[..., :jc.vocab]
                                  - f32(want)[..., :jc.vocab])))
    assert max(errs) <= ATOL_LOGITS, errs
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert sorted(tcache["pos"][0, 0].tolist()) == list(range(24, 40))


# -- MoE ---------------------------------------------------------------------------


def _moe_pair(arch, tp_w=16, **overrides):
    jc, tc = configs(arch, **overrides)
    jp, _ = jmoe.moe_init(KEY, jc, tp=tp_w)
    tparams = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    tparams = {k: v if k in ("router", "shared_gate") else v.bfloat16()
               for k, v in tparams.items()}
    return jc, tc, jp, tparams


def test_route_matches_jax():
    jc, tc, jp, tp = _moe_pair("qwen2_moe_a2_7b")
    jx, tx = bf16(moe_input((48,), jc.d_model))
    ji, jprob, jaux = jmoe._route(jp, jx, jc)
    ti, tprob, taux = moe._route(tp, tx, tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "qwen3_moe_30b_a3b"])
def test_moe_apply_dense_matches_jax(arch):
    """qwen2-moe smoke has shared experts; both drop some of 64 tokens at
    the published capacity factor."""
    jc, tc, jp, tp = _moe_pair(arch)
    jx, tx = bf16(moe_input((2, 32), jc.d_model, seed=3))
    want, jaux = jax_exact(lambda p, x: jmoe.moe_apply_dense(p, x, jc), jp,
                           jx)(jp, jx)
    got, taux = moe.moe_apply_dense(tp, tx, tc)
    close(got, want, ATOL_MODULE, arch)
    assert float(taux["moe_dropped"]) == float(jaux["moe_dropped"])
    np.testing.assert_allclose(float(taux["moe_aux"]), float(jaux["moe_aux"]),
                               rtol=1e-6)


def test_moe_dense_capacity_drops_are_counted():
    """The port's version of tests/test_models.py's test: a tight capacity
    must drop, the same count as the JAX package."""
    jc, tc, jp, tp = _moe_pair("qwen3_moe_30b_a3b", tp_w=4,
                               capacity_factor=0.1)
    jx, tx = bf16(moe_input((2, 32), jc.d_model, seed=4))
    want, jaux = jmoe.moe_apply_dense(jp, jx, jc)
    got, taux = moe.moe_apply_dense(tp, tx, tc)
    assert got.shape == tx.shape
    assert float(taux["moe_dropped"]) > 0
    assert float(taux["moe_dropped"]) == float(jaux["moe_dropped"])


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_sphere_matches_jax(grid_ref, case):
    """The sphere dispatch on the ``(2, 4)`` grid against the JAX
    package's, output, ``moe_aux`` and ``moe_dropped`` (data row 0's, as
    the JAX package hands them out). Without drops it also stays within
    0.3 of the dense dispatch (the bound of tests/test_spmd.py: the
    sphere path ships the routing probability in bfloat16); at the
    published capacity factor it drops."""
    tag, axes, tp_w, cf, shape = case
    jc, tc, jp, tp = _moe_pair(MOE_ARCH, tp_w=tp_w, capacity_factor=cf)
    x = moe_input(shape, tc.d_model)
    _, tx = bf16(x)
    rk = Ranks(shape=(2, 4), axes=axes, device="cpu")
    if axes[0] == "data":
        got, aux = moe.moe_apply_sphere(tp, tx, tc, rk, ("data",))
    else:
        got, aux = moe.moe_apply_sphere(tp, tx, tc, rk, (), ep_axes=axes)
    close(got, grid_ref[f"{tag}_out"], ATOL_MODULE, tag)
    assert int(aux["moe_dropped"]) == int(grid_ref[f"{tag}_dropped"])
    np.testing.assert_allclose(float(aux["moe_aux"]),
                               float(grid_ref[f"{tag}_aux"]), rtol=1e-6)
    if cf >= 8.0:
        assert int(aux["moe_dropped"]) == 0
        dense, _ = moe.moe_apply_dense(tp, tx, tc)
        close(got, dense, 0.3, "sphere vs dense")
    else:
        assert int(aux["moe_dropped"]) > 0


@pytest.mark.parametrize("case", RAISE_CASES,
                         ids=[f"{a}-{n}-{s[0]}x{s[1]}-{x[0]}"
                              for a, n, s, x in RAISE_CASES])
def test_moe_sphere_padding_mismatch_raises_where_jax_fails(grid_ref, case):
    """Finding 2: the weights pad the experts to a multiple of 16, the
    dispatch to a multiple of the expert axis; where the counts differ the
    JAX package fails inside ``shard_map`` and the port raises a
    ``ValueError`` naming both, and nowhere else."""
    arch, ne, shape, axes = case
    jax_raised = bool(grid_ref["raises"][RAISE_CASES.index(case)])
    tc = get_smoke_config(arch)
    if ne:
        tc = dataclasses.replace(tc, num_experts=ne)
    tp = moe.MoE(tc, device="cpu")
    tp.init_weights(torch.Generator().manual_seed(0))
    x = torch.zeros((8, 16, tc.d_model), dtype=torch.bfloat16)
    rk = Ranks(shape=shape, axes=axes, device="cpu")
    dp, ep = (("data",), None) if axes[0] == "data" else ((), axes)
    ep_size = shape[1] if ep is None else shape[0] * shape[1]
    if jax_raised:
        with pytest.raises(ValueError, match=f"hold {tp.w_gate.shape[0]} "
                           f".*to {moe.padded_experts(tc, ep_size)}"):
            moe.moe_apply_sphere(tp, x, tc, rk, dp, ep_axes=ep)
    else:
        out, aux = moe.moe_apply_sphere(tp, x, tc, rk, dp, ep_axes=ep)
        assert out.shape == x.shape


def test_moe_apply_takes_the_sphere_path_only_when_the_sequence_shards(
        monkeypatch):
    """The gate of the JAX package: a sequence the expert axis divides
    goes through the shuffle (one ``all_to_all`` there and one back, the
    partition rank twice), a decode step (S = 1) through the dense
    dispatch."""
    jc, tc, jp, tp = _moe_pair("qwen3_moe_30b_a3b", tp_w=4,
                               capacity_factor=8.0)
    rk = Ranks(shape=(2, 4), axes=("data", "model"), device="cpu")
    calls = []

    def counting(dest, num_dest):
        calls.append((tuple(dest.shape), num_dest))
        return partition.partition_rank(dest, num_dest)

    monkeypatch.setattr(kops, "partition_rank", counting)
    _, tx = bf16(moe_input((2, 8), tc.d_model))
    moe.moe_apply(tp, tx, tc, rk)
    assert rk.collectives["all_to_all"] == 2
    # the send pack over 4 expert ranks, (R, n_local * k), then the
    # regroup over the 2 local experts
    assert [c[1] for c in calls] == [4, 2]
    assert calls[0][0] == (8, 1 * 2 * tc.top_k)
    out1, _ = moe.moe_apply(tp, tx[:, :1], tc, rk)
    assert rk.collectives["all_to_all"] == 2 and len(calls) == 2
    dense, _ = moe.moe_apply_dense(tp, tx[:, :1], tc)
    np.testing.assert_array_equal(f32(out1), f32(dense))


# -- the model ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_prefill_and_12_decode_steps_match_jax(arch):
    jc, tc, jp, tp = both_params(arch)
    jm, tm = jax_build(jc), build(tc)
    v = jc.vocab
    toks = np.random.default_rng(9).integers(0, v, (2, 12)).astype(np.int32)
    got, _, taux = transformer.lm_forward(tp, tc, torch.from_numpy(toks))

    def fwd(p, t):
        return jtransformer.lm_forward(p, jc, t)

    want, _, jaux = jax_exact(fwd, jp, toks)(jp, toks)
    close(got[..., :v], want[..., :v], ATOL_LOGITS, "lm_forward")
    compiled, _, _ = jax.jit(fwd)(jp, toks)        # XLA's defaults
    close(got[..., :v], compiled[..., :v], ATOL_COMPILED, "compiled")
    if jc.is_moe:
        assert float(taux["moe_dropped"]) == float(jaux["moe_dropped"])
        np.testing.assert_allclose(float(taux["moe_aux"]),
                                   float(jaux["moe_aux"]), rtol=1e-6)

    jcache, tcache = jm.init_caches(2, 24), tm.init_caches(2, 24, "cpu")
    b = {"tokens": toks}
    want, jcache = jax_exact(jm.prefill, jp, b, jcache)(jp, b, jcache)
    got, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcache)
    assert got.shape == (2, 1, want.shape[-1])
    close(got[..., :v], want[..., :v], ATOL_LOGITS, "prefill")
    nxt = f32(want)[:, -1, :v].argmax(-1).astype(np.int32)
    decode = None
    for t in range(12, 24):
        b = {"tokens": nxt[:, None], "pos": np.full((2, 1), t, np.int32)}
        decode = decode or jax_exact(jm.decode_step, jp, jcache, b)
        want, jcache = decode(jp, jcache, b)
        got, tcache = tm.decode_step(tp, tcache, {
            k: torch.from_numpy(x) for k, x in b.items()})
        close(got[..., :v], want[..., :v], ATOL_LOGITS, f"decode {t}")
        nxt = f32(want)[:, -1, :v].argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    close(tcache["k"], jcache["k"], ATOL_MODULE, "cache k")


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "h2o_danube_1_8b",
                                  "qwen2_moe_a2_7b"])
def test_decode_matches_prefill(arch):
    """The port's version of tests/test_models.py's test, its bound 0.25:
    decoding through the cache gives the full forward's logits. MoE at a
    no-drop capacity, so both see the same expert sets."""
    tc = get_smoke_config(arch)
    if tc.is_moe:
        tc = dataclasses.replace(tc, capacity_factor=16.0)
    tm = build(tc)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab, (B, S)).astype(np.int32))
    with torch.inference_mode():
        full, _, _ = transformer.lm_forward(params, tc, toks)
    caches = tm.init_caches(B, S, "cpu")
    outs = []
    for t in range(S):
        lg, caches = tm.decode_step(params, caches, {
            "tokens": toks[:, t:t + 1],
            "pos": torch.full((B, 1), t, dtype=torch.int32)})
        outs.append(lg[:, 0])
    err = float(torch.max(torch.abs(torch.stack(outs, 1) - full)))
    assert err < 0.25, (arch, err)


def test_grid_prefill_matches_jax(grid_ref):
    """qwen2-moe smoke with 16 experts, capacity factor 8, prefilled into
    caches on the ``(2, 4)`` ``(data, model)`` grid: every MoE layer goes
    through the sphere dispatch; logits, caches, ``moe_aux`` and
    ``moe_dropped`` against the JAX package's grid prefill."""
    jc, tc, jp, tp = both_params(PREFILL_ARCH, num_experts=PREFILL_EXPERTS,
                                 capacity_factor=PREFILL_CF)
    tm = build(tc)
    rk = Ranks(shape=(2, 4), axes=("data", "model"), device="cpu")
    toks = torch.from_numpy(prefill_tokens(tc.vocab))
    caches = tm.init_caches(toks.shape[0], PREFILL_MAX_LEN, "cpu")
    with torch.inference_mode():
        logits, caches, aux = transformer.lm_forward(
            tp, tc, toks, caches=caches, ranks=rk, last_only=True)
    assert rk.collectives["all_to_all"] == 2 * tc.num_layers
    v = tc.vocab
    close(logits[..., :v], grid_ref["prefill_logits"][..., :v], ATOL_LOGITS)
    np.testing.assert_array_equal(caches["pos"].numpy(),
                                  grid_ref["prefill_pos"])
    close(caches["k"], grid_ref["prefill_k"], ATOL_MODULE, "cache k")
    assert float(aux["moe_dropped"]) == float(grid_ref["prefill_dropped"]) == 0
    np.testing.assert_allclose(float(aux["moe_aux"]),
                               float(grid_ref["prefill_aux"]), rtol=1e-6)
    # the serving entry point gives the same logits
    caches = tm.init_caches(toks.shape[0], PREFILL_MAX_LEN, "cpu")
    again, _ = tm.prefill(tp, {"tokens": toks}, caches, ranks=rk)
    np.testing.assert_array_equal(again.numpy(), logits.numpy())


# -- registry and the weight carrier --------------------------------------------------


@pytest.mark.parametrize("arch,item", [
    ("minicpm3_4b", "item 3"), ("xlstm_125m", "item 4"),
    ("zamba2_1_2b", "item 4"), ("whisper_small", "item 5"),
    ("internvl2_1b", "item 6")])
def test_build_refuses_families_not_ported_yet(arch, item):
    """Named for when these five families were refused (their ROADMAP.md
    queue 1 item in the id): each is ported now, so ``build`` refuses
    none of them, the registry keeps no list of families still to port,
    and the model holds the family's own modules."""
    from repro_torch.models import registry
    assert not hasattr(registry, "NOT_PORTED"), item
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    want = {"minicpm3_4b": "attn.wkv_down", "xlstm_125m": "cell.r_gates",
            "zamba2_1_2b": "mamba.in_bcdt", "whisper_small": "cross_attn.wq",
            "internvl2_1b": "img_proj"}[arch]
    assert any(n.endswith(want) for n, _ in params.named_parameters()), arch


def test_params_from_numpy_carries_every_weight():
    """Names, shapes and dtypes; padded experts (``w_gate``, ``w_up``)
    and padded vocabulary rows zero; each bfloat16 weight equal to the
    JAX package's ``.astype(bfloat16)``, the float32 ones equal."""
    jc, tc, jp, tp = both_params("qwen2_moe_a2_7b")
    tree = flatten(jax.tree.map(np.asarray, jp))
    own = dict(tp.named_parameters())
    assert set(own) == set(tree)
    assert "blocks.1.moe.w_gate" in own and "blocks.0.attn.wq" in own
    keep_f32 = ("router", "shared_gate", "ln1", "ln2", "final_ln")
    for name, p in own.items():
        assert tuple(p.shape) == tree[name].shape, name
        want = (torch.float32 if name.split(".")[-1] in keep_f32
                else torch.bfloat16)
        assert p.dtype == want, name
        ref = np.asarray(jnp.asarray(tree[name]).astype(
            jnp.bfloat16 if want == torch.bfloat16 else jnp.float32)
            .astype(jnp.float32))
        np.testing.assert_array_equal(p.float().numpy(), ref, err_msg=name)
    e = jc.num_experts
    for blk in tp.blocks:
        assert not blk.moe.w_gate[e:].any() and not blk.moe.w_up[e:].any()
    assert not tp.embed[jc.vocab:].any()
    with pytest.raises(ValueError, match="differ"):
        bad = {k: v for k, v in jax.tree.map(np.asarray, jp).items()
               if k != "final_ln"}
        params_from_numpy(bad, tc, "cpu")


def test_init_draws_as_the_jax_package_lays_out():
    """The port's own random init: stored dtypes, padding zero, norms
    one, the JAX package's scales, and the same weights for the same
    seed."""
    tc = get_smoke_config("qwen2_moe_a2_7b")
    tm = build(tc)
    a = tm.init(torch.Generator().manual_seed(3), "cpu")
    b = tm.init(torch.Generator().manual_seed(3), "cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
        assert torch.isfinite(pa.float()).all(), na
    m = a.blocks[0].moe
    assert not m.w_gate[tc.num_experts:].any()
    assert m.w_down[tc.num_experts:].any()         # as moe_init draws it
    assert not a.embed[tc.vocab:].any() and (a.final_ln == 1).all()
    assert m.router.dtype == torch.float32 and m.w_up.dtype == torch.bfloat16
    std = float(m.router.std())
    assert 0.015 < std < 0.025                     # scale 0.02
    std = float(a.blocks[0].attn.wq.float().std())
    assert abs(std - tc.d_model ** -0.5) < 0.2 * tc.d_model ** -0.5
