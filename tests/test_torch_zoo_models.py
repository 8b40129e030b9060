"""The five remaining model families of the port as whole models, on the
CPU, against the JAX package: minicpm3 (MLA), xlstm (mLSTM + sLSTM),
zamba2 (Mamba2 + shared attention), whisper (enc-dec) and internvl2
(VLM), each at its smoke config, and at its published config as a
parameter layout.

The weights are the JAX package's ``init`` at ``PRNGKey(0)``, carried
across by ``params_from_numpy``; the JAX functions are compiled with
XLA's excess precision off (``tests/test_torch_models.py``). Tolerances:
``ATOL_LOGITS`` (5e-2) on float32 logits against the JAX package, and
the JAX package's own ``test_decode_matches_prefill`` bound (0.25) for
decoding through caches against a full forward inside the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build as jax_build
from repro.models import encdec as jencdec
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import build, encdec, transformer
from repro_torch.models.convert import flatten, params_from_numpy
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import DecoderLM

ATOL_LOGITS = 5e-2
DECODE_TOL = 0.25
KEY = jax.random.PRNGKey(0)
NO_EXCESS = {"xla_allow_excess_precision": False}
ZOO = ("minicpm3_4b", "xlstm_125m", "zamba2_1_2b", "whisper_small",
       "internvl2_1b")
#: parameters of the published configs, as the JAX package lays them out
#: (the table of the port's slice: minicpm3 about 4.1e9, zamba2 1.1e9,
#: internvl2 0.5e9, whisper 0.24e9, xlstm 0.15e9)
PUBLISHED_PARAMS = {"minicpm3_4b": (4.0e9, 4.2e9),
                    "zamba2_1_2b": (1.0e9, 1.2e9),
                    "internvl2_1b": (0.45e9, 0.55e9),
                    "whisper_small": (0.2e9, 0.28e9),
                    "xlstm_125m": (0.12e9, 0.18e9)}


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(got, want, atol, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= atol, f"{what}: max |port - jax| = {err} > {atol}"


def jax_exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(NO_EXCESS)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    params, _ = jax_build(jax_smoke_config(arch)).init(KEY)
    return params


def both(arch):
    jc, tc = jax_smoke_config(arch), get_smoke_config(arch)
    jp = _jax_params(arch)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                         "cpu")


def inputs(cfg, b=2, s=12, seed=9):
    """tokens, and the frames or image embeddings the family needs, as
    numpy (float32, rounded to bfloat16 by both packages)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (b, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    return out


def as_jax(batch):
    return {k: jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32
            else jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(v).bfloat16() if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


def cache_leaves(caches):
    if isinstance(caches, dict):
        return [caches]
    return list(caches)


# -- build, layout, carrier ------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_at_both_sizes(arch):
    """No family is refused any more: ``build`` of the smoke and the
    published config, and a smoke init, prefill and decode step."""
    build(get_config(arch))
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = as_torch(inputs(cfg, b=1, s=4))
    caches = model.init_caches(1, 16 + cfg.img_tokens, "cpu")
    logits, caches = model.prefill(params, batch, caches)
    assert torch.isfinite(logits[..., :cfg.vocab]).all()
    step = {"tokens": torch.ones((1, 1), dtype=torch.int32),
            "pos": torch.full((1, 1), 4 + cfg.img_tokens, dtype=torch.int32)}
    if cfg.family == "audio":
        step["enc_out"] = encdec.encode(params, cfg, batch["frames"])
    logits, _ = model.decode_step(params, caches, step)
    assert logits.shape == (1, 1, params.embed.shape[0])


@pytest.mark.parametrize("arch", ZOO)
def test_published_config_holds_the_jax_layout(arch):
    """The published config's module, built on the ``meta`` device,
    holds exactly the JAX package's parameter names and shapes
    (``jax.eval_shape`` of its init; zero-stride arrays stand in for the
    values), and about the parameter count the port's slice names."""
    jc = jax_config(arch)
    shapes = jax.eval_shape(lambda k: jax_build(jc).init(k)[0], KEY)
    tree = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        shapes)
    want = {k: v.shape for k, v in flatten(tree).items()}
    model = (EncDec if jc.family == "audio" else DecoderLM)(
        get_config(arch), "meta")
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == want
    n = sum(p.numel() for p in model.parameters())
    lo, hi = PUBLISHED_PARAMS[arch]
    assert lo <= n <= hi, n


@pytest.mark.parametrize("arch", ZOO)
def test_params_from_numpy_carries_every_weight(arch):
    """Names and shapes equal; each weight equal to the JAX package's
    value in the dtype the port stores (bfloat16 for what the JAX
    package casts to it before use, float32 otherwise; both round to
    nearest even, as tests/test_torch_models.py holds against
    ``astype``); a tree missing a leaf is refused."""
    jc, tc, jp, tp = both(arch)
    tree = flatten(jax.tree.map(np.asarray, jp))
    own = dict(tp.named_parameters())
    assert set(own) == set(tree)
    for name, p in own.items():
        ref = torch.from_numpy(np.asarray(tree[name], np.float32))
        assert torch.equal(p, ref.to(p.dtype)), name
    assert not tp.embed[jc.vocab:].any()
    with pytest.raises(ValueError, match="differ"):
        bad = {k: v for k, v in jax.tree.map(np.asarray, jp).items()
               if k != "final_ln"}
        params_from_numpy(bad, tc, "cpu")


# -- logits and decode against the JAX package -----------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_12_decode_steps_match_jax(arch):
    """The full forward (``lm_forward`` / teacher-forced ``decode_stack``),
    the prefill into caches of 40 and 12 greedy decode steps, against the
    JAX package's; the caches' positions exactly."""
    jc, tc, jp, tp = both(arch)
    jm, tm = jax_build(jc), build(tc)
    v = jc.vocab
    batch = inputs(jc)
    jb, tb = as_jax(batch), as_torch(batch)

    if jc.family == "audio":
        def full(p, b):
            return jencdec.decode_stack(p, jc, b["tokens"], jencdec.encode(
                p, jc, b["frames"]))[0]
        got = encdec.decode_stack(tp, tc, tb["tokens"],
                                  encdec.encode(tp, tc, tb["frames"]))[0]
    else:
        def full(p, b):
            return jtransformer.lm_forward(p, jc, b["tokens"],
                                           img_embeds=b.get("img_embeds"))[0]
        got = transformer.lm_forward(tp, tc, tb["tokens"],
                                     img_embeds=tb.get("img_embeds"))[0]
    close(got[..., :v], jax_exact(full, jp, jb)(jp, jb)[..., :v],
          ATOL_LOGITS, "full forward")

    jcache, tcache = jm.init_caches(2, 40), tm.init_caches(2, 40, "cpu")
    want, jcache = jax_exact(jm.prefill, jp, jb, jcache)(jp, jb, jcache)
    got, tcache = tm.prefill(tp, tb, tcache)
    close(got[..., :v], want[..., :v], ATOL_LOGITS, "prefill")
    start = batch["tokens"].shape[1] + jc.img_tokens
    extra_j, extra_t = {}, {}
    if jc.family == "audio":
        extra_j["enc_out"] = jax_exact(lambda p, f: jencdec.encode(p, jc, f),
                                       jp, jb["frames"])(jp, jb["frames"])
        extra_t["enc_out"] = encdec.encode(tp, tc, tb["frames"])
    nxt = f32(want)[:, -1, :v].argmax(-1).astype(np.int32)
    decode = None
    for t in range(start, start + 12):
        step = {"tokens": nxt[:, None], "pos": np.full((2, 1), t, np.int32)}
        jstep = dict(step, **extra_j)
        decode = decode or jax_exact(jm.decode_step, jp, jcache, jstep)
        want, jcache = decode(jp, jcache, jstep)
        got, tcache = tm.decode_step(tp, tcache, dict(
            {k: torch.from_numpy(x) for k, x in step.items()}, **extra_t))
        close(got[..., :v], want[..., :v], ATOL_LOGITS, f"decode {t}")
        nxt = f32(want)[:, -1, :v].argmax(-1).astype(np.int32)
    jleaves = cache_leaves(jcache)
    for i, c in enumerate(cache_leaves(tcache)):
        assert set(c) == set(jleaves[i])
        if "pos" in c:
            np.testing.assert_array_equal(c["pos"].numpy(),
                                          np.asarray(jleaves[i]["pos"]))


@pytest.mark.parametrize("arch", ZOO)
def test_decode_matches_prefill(arch):
    """The port's version of tests/test_models.py's test, its bound
    0.25: decoding token by token through the caches gives the full
    forward's logits. internvl2 prefills its image embeddings first;
    whisper decodes against one encoder output, teacher-forced as the
    reference."""
    tc = get_smoke_config(arch)
    tm = build(tc)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 12
    batch = as_torch(inputs(tc, B, S, seed=1))
    toks = batch["tokens"]
    caches = tm.init_caches(B, S + tc.img_tokens, "cpu")
    extra, start = {}, 0
    with torch.inference_mode():
        if tc.family == "audio":
            extra["enc_out"] = encdec.encode(params, tc, batch["frames"])
            full, _ = encdec.decode_stack(params, tc, toks, extra["enc_out"])
        else:
            full, _, _ = transformer.lm_forward(
                params, tc, toks, img_embeds=batch.get("img_embeds"))
            full = full[:, tc.img_tokens:]
        if tc.family == "vlm":
            _, caches = tm.prefill(params, {
                "tokens": toks[:, :1], "img_embeds": batch["img_embeds"]},
                caches)
            start = 1
            outs = [None]
        else:
            outs = []
    for t in range(start, S):
        lg, caches = tm.decode_step(params, caches, dict({
            "tokens": toks[:, t:t + 1],
            "pos": torch.full((B, 1), t + tc.img_tokens,
                              dtype=torch.int32)}, **extra))
        outs.append(lg[:, 0])
    if tc.family == "vlm":
        full = full[:, 1:]
        outs = outs[1:]
    err = float(torch.max(torch.abs(torch.stack(outs, 1) - full)))
    assert err < DECODE_TOL, (arch, err)


def _exact_products(monkeypatch):
    """Every bfloat16 ``@`` and float32 ``einsum`` of the port computed
    exactly (in float64, then rounded once): its results no longer depend
    on the shapes of the products."""
    matmul, einsum = torch.Tensor.__matmul__, torch.einsum

    def exact_matmul(a, b):
        if a.dtype == b.dtype == torch.bfloat16:
            return matmul(a.double(), b.double()).to(torch.bfloat16)
        return matmul(a, b)

    def exact_einsum(eq, *ops):
        if all(o.dtype == torch.float32 for o in ops):
            return einsum(eq, *[o.double() for o in ops]).float()
        return einsum(eq, *ops)
    monkeypatch.setattr(torch.Tensor, "__matmul__", exact_matmul)
    monkeypatch.setattr(torch, "einsum", exact_einsum)


@pytest.mark.parametrize("arch", ["minicpm3_4b", "whisper_small",
                                  "internvl2_1b", "tinyllama_1_1b"])
def test_decode_computes_the_full_forward_exactly(arch, monkeypatch):
    """With exact products, decoding token by token through the caches
    gives the full forward's logits to the bit: the two differ only in
    the shapes of their products, so in their rounding (on the card a
    deep random stack amplifies that; ``chip_smoke.py`` phase 13 measures
    it). The attention families only: the chunked and the recurrent forms
    of the SSM cells are other sums."""
    _exact_products(monkeypatch)
    tc = get_smoke_config(arch)
    tm = build(tc)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 12
    batch = as_torch(inputs(tc, B, S, seed=1))
    toks = batch["tokens"]
    extra, n_img = {}, tc.img_tokens
    with torch.inference_mode():
        if tc.family == "audio":
            extra["enc_out"] = encdec.encode(params, tc, batch["frames"])
            full, _ = encdec.decode_stack(params, tc, toks, extra["enc_out"])
        else:
            full, _, _ = transformer.lm_forward(
                params, tc, toks, img_embeds=batch.get("img_embeds"))
            full = full[:, n_img:]
        caches = tm.init_caches(B, S + n_img, "cpu")
        first, caches = tm.prefill(params, dict(batch, tokens=toks[:, :1]),
                                   caches)
    outs = [first[:, -1]]
    for t in range(1, S):
        lg, caches = tm.decode_step(params, caches, dict({
            "tokens": toks[:, t:t + 1],
            "pos": torch.full((B, 1), t + n_img, dtype=torch.int32)},
            **extra))
        outs.append(lg[:, 0])
    assert torch.equal(torch.stack(outs, 1), full), arch
