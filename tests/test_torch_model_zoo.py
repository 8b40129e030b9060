"""The rest of the port's model zoo, module by module, against the JAX
package on the CPU: MLA attention (minicpm3), the Mamba2 SSD block
(zamba2), the mLSTM and sLSTM cells (xlstm), the whisper encoder and its
cross-attending decoder, the VLM image path and the sinusoids.

Both packages get the same numpy inputs (rounded to bfloat16 in both);
each JAX module's own ``init`` draws the weights, which are copied into
the port's module of the same names (matrices bfloat16, the rest float32,
as ``convert.params_from_numpy`` stores them). The JAX functions are
compiled with XLA's excess precision off (see
``tests/test_torch_models.py``), so the two agree but for an ulp here and
there; the tolerances are that file's: ``ATOL_MODULE`` (3e-2) on a
module's bfloat16 output, float32 states at ``ATOL_STATE`` (1e-4 of their
magnitude, the order of a float32 sum), the sinusoids at ``ATOL_SIN``
(an ulp of the float32 angle: ``sin``/``cos`` are other implementations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, encdec, layers, ssm, transformer
from repro_torch.models.convert import params_from_numpy

ATOL_MODULE = 3e-2
ATOL_STATE = 1e-4
ATOL_SIN = 1e-5
#: the JAX package's test_mla_absorb_matches_naive bound
ABSORB_TOL = 0.1
KEY = jax.random.PRNGKey(0)
NO_EXCESS = {"xla_allow_excess_precision": False}


def jax_exact(fn, *args):
    """``fn`` compiled for ``args`` with excess precision off, called on
    them, its result ready."""
    return jax.block_until_ready(
        jax.jit(fn).lower(*args).compile(NO_EXCESS)(*args))


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(got, want, atol, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= atol, f"{what}: max |port - jax| = {err} > {atol}"


def close_state(got, want, what=""):
    """float32 states: within ATOL_STATE of their largest magnitude."""
    want32 = f32(want)
    close(got, want32, ATOL_STATE * max(1.0, float(np.abs(want32).max())),
          what)


def bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def load(module: torch.nn.Module, tree) -> torch.nn.Module:
    """``module`` holding the JAX dict's values, each cast to the
    parameter's dtype."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    walk(tree, "")
    own = dict(module.named_parameters())
    assert set(own) == set(flat), (sorted(own), sorted(flat))
    with torch.no_grad():
        for name, p in own.items():
            assert tuple(p.shape) == flat[name].shape, name
            p.copy_(torch.from_numpy(flat[name].astype(np.float32)))
    return module


def positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


def torch_cache(tree):
    """The same state as a port cache, in memory of its own: the port
    writes a cache in place, and a zero-copy view of a JAX buffer would
    let it overwrite an input of a JAX computation still running."""
    return {k: torch.from_numpy(np.array(jnp.asarray(v).astype(
        jnp.float32))).to(torch.bfloat16 if v.dtype == jnp.bfloat16
                          else torch.float32 if v.dtype == jnp.float32
                          else torch.int32)
            for k, v in tree.items()}


# -- layers ---------------------------------------------------------------------


def test_sinusoids_match_jax():
    got = layers.sinusoid_positions(37, 64)
    close(got, jlayers.sinusoid_positions(37, 64), ATOL_SIN, "positions")
    pos = positions(2, 9, start=20)
    close(layers.sinusoid_at(torch.from_numpy(pos), 96),
          jencdec._sinusoid_at(jnp.asarray(pos), 96), ATOL_SIN, "at")


# -- MLA -------------------------------------------------------------------------


def _mla_pair():
    jc, tc = jax_smoke_config("minicpm3_4b"), get_smoke_config("minicpm3_4b")
    jp, _ = jattn.attn_init(KEY, jc)
    return jc, tc, jp, load(attention.MLA(tc, "cpu"), jp)


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_apply_without_cache_matches_jax(absorb):
    jc, tc, jp, tp = _mla_pair()
    jx, tx = bf16(normal((2, 11, jc.d_model), 6))
    pos = positions(2, 11)
    want, _ = jax_exact(lambda p, x, q: jattn.mla_apply(
        p, x, jc, q, absorb=absorb), jp, jx, pos)
    got, cache = attention.mla_apply(tp, tx, tc, torch.from_numpy(pos),
                                     absorb=absorb)
    assert cache is None
    close(got, want, ATOL_MODULE, f"absorb={absorb}")


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_apply_prefill_and_decode_with_cache_match_jax(absorb):
    """10 positions into a latent cache of 16, then one decode step; the
    cache is no ring: ckv, k_rope and positions land at their slots."""
    jc, tc, jp, tp = _mla_pair()
    jx, tx = bf16(normal((2, 11, jc.d_model), 7))
    pos = positions(2, 11)
    jcache = jattn.init_cache_mla(jc, 2, 16)
    tcache = attention.init_cache_mla(tc, 2, 16)

    def step(p, x, q, c):
        return jattn.mla_apply(p, x, jc, q, c, absorb=absorb)

    for sl in (slice(0, 10), slice(10, 11)):
        want, jcache = jax_exact(step, jp, jx[:, sl], pos[:, sl], jcache)
        got, tcache = attention.mla_apply(tp, tx[:, sl], tc,
                                          torch.from_numpy(pos[:, sl]),
                                          tcache, absorb=absorb)
        close(got, want, ATOL_MODULE, f"absorb={absorb} {sl}")
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    close(tcache["ckv"], jcache["ckv"], ATOL_MODULE, "ckv")
    close(tcache["k_rope"], jcache["k_rope"], ATOL_MODULE, "k_rope")


def test_mla_absorb_matches_naive():
    """The port's version of tests/test_models.py's test: the absorbed
    (latent-space, float32) scores give the naive path's output within
    its bound."""
    _, tc, _, tp = _mla_pair()
    _, tx = bf16(normal((2, 8, tc.d_model), 2))
    pos = torch.from_numpy(positions(2, 8))
    naive, _ = attention.mla_apply(tp, tx, tc, pos, absorb=False)
    absorbed, _ = attention.mla_apply(tp, tx, tc, pos, absorb=True)
    err = float((naive.float() - absorbed.float()).abs().max())
    assert err < ABSORB_TOL, err


# -- Mamba2 / mLSTM / sLSTM ---------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    """The K taps summed in bfloat16 in the JAX package's order, then the
    bias and SiLU; the carried state is the last K - 1 inputs."""
    jx, tx = bf16(normal((2, 9, 24), 1))
    jw, tw = bf16(normal((4, 24), 2, 0.5))
    jb, tb = bf16(normal((24,), 3, 0.1))
    js = ts = None
    if with_state:
        js, ts = bf16(normal((2, 3, 24), 4))
    want, wstate = jax_exact(lambda x, w, b, s: jssm._causal_conv(x, w, b, s),
                             jx, jw, jb, js)
    got, gstate = ssm._causal_conv(tx, tw, tb, ts)
    close(got, want, ATOL_MODULE, "y")
    np.testing.assert_array_equal(f32(gstate), f32(wstate))


#: (config, port class, JAX init, JAX apply, port apply, JAX init_cache)
CELLS = {
    "mamba2": ("zamba2_1_2b", ssm.Mamba2, jssm.mamba2_init,
               jssm.mamba2_apply, ssm.mamba2_apply, jssm.mamba2_init_cache),
    "mlstm": ("xlstm_125m", ssm.MLSTM, jssm.mlstm_init, jssm.mlstm_apply,
              ssm.mlstm_apply, jssm.mlstm_init_cache),
    "slstm": ("xlstm_125m", ssm.SLSTM, jssm.slstm_init, jssm.slstm_apply,
              ssm.slstm_apply, jssm.slstm_init_cache),
}


@pytest.mark.parametrize("mode", ["prefill", "prefill_into_state", "step"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_recurrent_cell_matches_jax(cell, mode):
    """13 positions (not a multiple of the smoke chunk of 8: padded) with
    no cache; 13 positions from a carried state (the chunked path from
    ``cache``); one decode step from a carried state (the recurrent step).
    The carried state is the JAX cell's own after 7 other positions.
    Outputs at ATOL_MODULE, every state leaf at its dtype's tolerance."""
    arch, cls, jinit, japply, tapply, jinit_cache = CELLS[cell]
    jc, tc = jax_smoke_config(arch), get_smoke_config(arch)
    jp, _ = jinit(KEY, jc)
    tp = load(cls(tc, "cpu"), jp)

    def apply(p, x, c):
        return japply(p, x, jc, c)

    L = 1 if mode == "step" else 13
    jx, tx = bf16(normal((2, L, jc.d_model), 11))
    jcache = tcache = None
    if mode != "prefill":
        jwarm, _ = bf16(normal((2, 7, jc.d_model), 12))
        _, jcache = jax_exact(apply, jp, jwarm, jinit_cache(jc, 2))
        tcache = torch_cache(jcache)
    want, wcache = jax_exact(apply, jp, jx, jcache)
    got, gcache = tapply(tp, tx, tc, tcache)
    close(got, want, ATOL_MODULE, f"{cell} {mode}")
    if mode == "prefill":
        assert gcache is None and wcache is None
        return
    assert gcache is tcache                        # written in place
    assert set(gcache) == set(wcache)
    for k in wcache:
        if wcache[k].dtype == jnp.bfloat16:    # the conv's last inputs
            close(gcache[k], wcache[k], ATOL_MODULE, f"{cell} {mode} {k}")
        else:
            close_state(gcache[k], wcache[k], f"{cell} {mode} {k}")


def test_mlstm_starts_its_stabiliser_apart_with_and_without_a_cache():
    """The reference's two initial stabilisers: ``_mlstm_chunked`` alone
    starts ``m`` at -1e30, ``mlstm_init_cache`` at 0; the outputs agree
    (the stabiliser cancels) but the carried ``m`` differs, in both
    packages alike."""
    jc, tc = jax_smoke_config("xlstm_125m"), get_smoke_config("xlstm_125m")
    jp, _ = jssm.mlstm_init(KEY, jc)
    tp = load(ssm.MLSTM(tc, "cpu"), jp)
    _, tx = bf16(normal((2, 10, jc.d_model), 12))
    fresh, _ = ssm.mlstm_apply(tp, tx, tc)
    cache = ssm.mlstm_init_cache(tc, 2)
    cached, cache = ssm.mlstm_apply(tp, tx, tc, cache)
    close(cached, fresh, ATOL_MODULE, "outputs")
    jcache = jssm.mlstm_init_cache(jc, 2)
    _, jcache = jax_exact(lambda p, x, c: jssm.mlstm_apply(p, x, jc, c), jp,
                          jnp.asarray(f32(tx), jnp.bfloat16), jcache)
    close_state(cache["m"], jcache["m"], "m")
    d_in, H, Pd = ssm.mlstm_dims(tc)
    q = k = v = torch.zeros((1, 3, H, Pd))
    li = torch.zeros((1, 3, H))
    _, state = ssm._mlstm_chunked(q, k, v, li - 1e30, li, 8)
    assert float(state["m"].max()) < -1e29


# -- whisper ------------------------------------------------------------------------


def _whisper_pair():
    jc = jax_smoke_config("whisper_small")
    tc = get_smoke_config("whisper_small")
    jp, _ = jencdec.init_params(KEY, jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def test_encode_matches_jax():
    jc, tc, jp, tp = _whisper_pair()
    jf, tf = bf16(normal((2, jc.enc_seq, jc.d_model), 13))
    want = jax_exact(lambda p, f: jencdec.encode(p, jc, f), jp, jf)
    close(encdec.encode(tp, tc, tf), want, ATOL_MODULE, "encode")


@pytest.mark.parametrize("cached", [False, True])
def test_decode_stack_with_cross_kv_matches_jax(cached):
    """Teacher forcing over 7 tokens, or 6 into self-attention caches and
    one decode step: each block cross-attends over K/V recomputed from the
    encoder output (only ``q_norm`` on q, no rope)."""
    jc, tc, jp, tp = _whisper_pair()
    jeo, teo = bf16(normal((2, jc.enc_seq, jc.d_model), 14))
    toks = np.random.default_rng(15).integers(0, jc.vocab, (2, 7)).astype(
        np.int32)
    v = jc.vocab
    if not cached:
        want, _ = jax_exact(lambda p, t, e: jencdec.decode_stack(p, jc, t, e),
                            jp, toks, jeo)
        got, _ = encdec.decode_stack(tp, tc, torch.from_numpy(toks), teo)
        close(got[..., :v], want[..., :v], 5e-2, "teacher forcing")
        return
    jcache = jencdec.init_caches(jc, 2, 12)
    tcache = encdec.init_caches(tc, 2, 12)
    for sl in (slice(0, 6), slice(6, 7)):
        pos = positions(2, sl.stop - sl.start, sl.start)

        def dec(p, t, e, q, c):
            return jencdec.decode_stack(p, jc, t, e, q, c)
        want, jcache = jax_exact(dec, jp, toks[:, sl], jeo, pos, jcache)
        got, tcache = encdec.decode_stack(tp, tc, torch.from_numpy(
            toks[:, sl]), teo, torch.from_numpy(pos), tcache)
        close(got[..., :v], want[..., :v], 5e-2, f"decode {sl}")
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_cross_attention_matches_jax():
    """``attn_apply(cross_kv=...)`` on qwen3-moe smoke's attention (it has
    ``qk_norm``): q normalised, no rope, no mask but empty slots."""
    jc, tc = jax_smoke_config("qwen3_moe_30b_a3b"), get_smoke_config(
        "qwen3_moe_30b_a3b")
    jp, _ = jattn.attn_init(KEY, jc)
    tp = load(attention.Attention(tc, "cpu"), jp)
    jx, tx = bf16(normal((2, 5, jc.d_model), 16))
    jk, tk = bf16(normal((2, 9, jc.n_kv_heads, jc.hd), 17))
    jv, tv = bf16(normal((2, 9, jc.n_kv_heads, jc.hd), 18))
    kv_pos = positions(2, 9)
    kv_pos[1, 6:] = -1
    q_pos = positions(2, 5)
    want, _ = jax_exact(lambda p, x, q, k, v, kp: jattn.attn_apply(
        p, x, jc, q, cross_kv=(k, v, kp)), jp, jx, q_pos, jk, jv, kv_pos)
    got, cache = attention.attn_apply(
        tp, tx, tc, torch.from_numpy(q_pos),
        cross_kv=(tk, tv, torch.from_numpy(kv_pos)))
    assert cache is None
    close(got, want, ATOL_MODULE, "cross")


# -- the VLM image path ---------------------------------------------------------------


def test_embed_inputs_puts_the_projected_image_first_as_jax_does():
    jc, tc = jax_smoke_config("internvl2_1b"), get_smoke_config("internvl2_1b")
    jp, _ = jtransformer.init_params(KEY, jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    ji, ti = bf16(normal((2, jc.img_tokens, jc.d_model), 19))
    toks = np.random.default_rng(20).integers(0, jc.vocab, (2, 5)).astype(
        np.int32)
    want = jax_exact(lambda p, t, i: jtransformer.embed_inputs(p, jc, t, i),
                     jp, toks, ji)
    got = transformer.embed_inputs(tp, tc, torch.from_numpy(toks), ti)
    assert got.shape == (2, jc.img_tokens + 5, jc.d_model)
    close(got, want, ATOL_MODULE, "embed_inputs")
    np.testing.assert_array_equal(
        f32(got[:, jc.img_tokens:]),
        f32(transformer.embed_inputs(tp, tc, torch.from_numpy(toks))))
