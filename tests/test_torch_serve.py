"""The port's serving engine, on the CPU: the LM cases of
``tests/test_serve.py`` run on the port, and the port's engine against
the JAX package's ``ServeEngine`` on the same weights.

The JAX engine's decode step is compiled with XLA's excess precision
off (see ``tests/test_torch_models.py``): every op then rounds as the
program names it, as the port's does, and the token streams are held
equal whole, request by request. Tokens are compared exactly; sampling
(``temperature > 0``) draws from each package's own generator, so it is
held to repeat itself for a seed and to stay inside the vocabulary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_main
from repro_torch.models import build
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import lm_forward
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import Tracer
from repro_torch.serve import Request, ServeEngine
from repro_torch.sphere.streaming import QueueFull, TenantQueue

NO_EXCESS = {"xla_allow_excess_precision": False}


def make_engine(slots=2, max_len=64, arch="tinyllama_1_1b", **kw):
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params, ServeEngine(model, params, batch_slots=slots,
                                           max_len=max_len, **kw)


def greedy_reference(params, cfg, prompt, n_new):
    """Greedy decoding by repeated full forwards, no cache."""
    toks = list(map(int, prompt))
    with torch.inference_mode():
        for _ in range(n_new):
            logits, _, _ = lm_forward(params, cfg,
                                      torch.tensor([toks], dtype=torch.int32))
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def test_single_request_matches_full_forward_greedy():
    cfg, model, params, eng = make_engine(slots=1)
    prompt = np.array([5, 17, 3, 99], np.int32)
    eng.submit(Request(0, prompt, max_new_tokens=6))
    done = eng.run_to_completion()
    assert len(done) == 1
    assert done[0].out_tokens == greedy_reference(params, cfg, prompt, 6)


def test_many_requests_continuous_batching():
    cfg, model, params, eng = make_engine(slots=2)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=5).astype(np.int32),
                    max_new_tokens=4) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    done = eng.run_to_completion()
    assert sorted(r.req_id for r in done) == [0, 1, 2, 3, 4]
    assert all(len(r.out_tokens) == 4 for r in done)
    # batching must not corrupt per-request results
    for r in done[:2]:
        assert r.out_tokens == greedy_reference(params, cfg, r.prompt, 4)


def test_slot_reuse_isolation():
    """A slot reused by a second request must not see the first one's KV:
    ``_reset_slot_cache`` empties the slot (positions -1, zeros) first."""
    cfg, model, params, eng = make_engine(slots=1)
    p1 = np.array([1, 2, 3], np.int32)
    p2 = np.array([9, 8, 7, 6], np.int32)
    eng.submit(Request(0, p1, max_new_tokens=3))
    eng.submit(Request(1, p2, max_new_tokens=3))
    done = eng.run_to_completion()
    by_id = {r.req_id: r for r in done}
    assert by_id[1].out_tokens == greedy_reference(params, cfg, p2, 3)
    eng._reset_slot_cache(0)
    assert (eng.caches["pos"][:, 0] == -1).all()
    assert not eng.caches["k"][:, 0].any() and not eng.caches["v"][:, 0].any()


def test_run_to_completion_reports_unfinished_work():
    cfg, model, params, eng = make_engine(slots=1)
    reqs = [Request(i, np.array([3, 1 + i], np.int32), max_new_tokens=50)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    report = eng.run_to_completion(max_steps=2)
    assert not report.completed
    assert len(report.unfinished) > 0
    seen = sorted(r.req_id for r in list(report) + report.unfinished)
    assert seen == [0, 1, 2]
    assert all(not r.done for r in report.unfinished)
    assert isinstance(report, list)
    report2 = eng.run_to_completion()
    assert report2.completed
    assert {r.req_id for r in list(report) + list(report2)} == {0, 1, 2}


def test_tenant_mode_priority_and_fair_refills():
    """With the port's ``TenantQueue`` attached, refills follow strict
    priority, completions flow back into the tenants' stats, and a full
    queue raises ``QueueFull``."""
    cfg, model, params, _ = make_engine()
    tq = TenantQueue(quantum=4.0, capacity=8)
    tq.register("urgent", priority=0)
    tq.register("bulk", priority=1)
    eng = ServeEngine(model, params, batch_slots=1, max_len=64, tenants=tq)
    rng = np.random.default_rng(0)
    for i in range(2):          # bulk submitted FIRST, must still wait
        eng.submit(Request(i, rng.integers(0, cfg.vocab, size=4)
                           .astype(np.int32), max_new_tokens=3,
                           tenant="bulk"))
    for i in range(2, 4):
        eng.submit(Request(i, rng.integers(0, cfg.vocab, size=4)
                           .astype(np.int32), max_new_tokens=3,
                           tenant="urgent"))
    report = eng.run_to_completion()
    assert report.completed and len(report) == 4
    assert [r.req_id for r in report[:2]] == [2, 3]    # urgent first
    stats = tq.stats()
    assert stats["urgent"]["delivered"] == 2
    assert stats["bulk"]["delivered"] == 2
    assert stats["bulk"]["latency_p50"] >= stats["urgent"]["latency_p50"]
    for i in range(8):
        eng.submit(Request(10 + i, np.array([1, 2], np.int32),
                           max_new_tokens=2, tenant="bulk"))
    with pytest.raises(QueueFull):
        eng.submit(Request(99, np.array([1, 2], np.int32), max_new_tokens=2,
                           tenant="bulk"))
    assert eng.run_to_completion().completed


def _traffic(vocab, n=5):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 8))).astype(
        np.int32) for _ in range(n)]


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen2_moe_a2_7b"])
def test_engine_token_streams_match_the_jax_engine(arch):
    """Five requests through 2 slots (slots refill), greedy, on the JAX
    package's weights: every request's tokens equal the JAX engine's.
    qwen2-moe decodes through the dense dispatch at the published
    capacity factor, so tokens of one slot can drop experts that another
    slot's take: the streams must agree on that too."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jeng = JServeEngine(jmodel, jparams, batch_slots=2, max_len=32)
    batch = {"tokens": jnp.zeros((2, 1), jnp.int32),
             "pos": jnp.zeros((2, 1), jnp.int32)}
    jeng._decode = jax.jit(jmodel.decode_step).lower(
        jparams, jeng.caches, batch).compile(NO_EXCESS)
    eng = ServeEngine(build(cfg), params, batch_slots=2, max_len=32)
    prompts = _traffic(cfg.vocab)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(i, p, max_new_tokens=6))
        eng.submit(Request(i, p, max_new_tokens=6))
    want = {r.req_id: r.out_tokens for r in jeng.run_to_completion()}
    got = {r.req_id: r.out_tokens for r in eng.run_to_completion()}
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for i in want:
        assert got[i] == want[i], (i, got[i], want[i])


def test_sampling_repeats_for_a_seed_and_stays_in_the_vocabulary():
    """``temperature > 0`` draws from the engine's own generator: the same
    seed gives the same streams, another seed others, every token below
    ``vocab`` (the padded columns sit at -1e30)."""
    streams = []
    for seed in (7, 7, 8):
        cfg, model, params, eng = make_engine(slots=2, temperature=1.0,
                                              seed=seed)
        for i, p in enumerate(_traffic(cfg.vocab)):
            eng.submit(Request(i, p, max_new_tokens=8))
        done = eng.run_to_completion()
        streams.append({r.req_id: r.out_tokens for r in done})
        assert all(0 <= t < cfg.vocab for r in done for t in r.out_tokens)
    assert streams[0] == streams[1]
    assert streams[0] != streams[2]


def test_counters_trace_and_batch_axes():
    """The ``serve.*`` counters count steps, tokens and finished
    requests; a tracer gets one ``serve.step[i]`` span a step; the cache
    layout's batch axis is found on the ``meta`` device."""
    tracer = Tracer()
    cfg, model, params, eng = make_engine(slots=2, trace=tracer)
    assert eng._batch_axes == {"k": 1, "v": 1, "pos": 1}
    before = {k: REGISTRY.counter(k).value for k in
              ("serve.steps", "serve.tokens", "serve.finished")}
    for i, p in enumerate(_traffic(cfg.vocab, 3)):
        eng.submit(Request(i, p, max_new_tokens=4))
    done = eng.run_to_completion()
    delta = {k: REGISTRY.counter(k).value - v for k, v in before.items()}
    assert delta["serve.finished"] == 3
    assert delta["serve.tokens"] == sum(len(r.out_tokens) for r in done)
    spans = [s.name for s in tracer.buffer.spans()]
    assert spans == [f"serve.step[{i + 1}]" for i in range(eng.step_count)]
    assert delta["serve.steps"] == eng.step_count


def test_enc_dec_serving_is_not_ported_yet():
    """Named for when enc-dec serving was refused: the engine now serves
    whisper smoke, each request's frames encoded into its slot's memory,
    every token inside the vocabulary."""
    cfg, model, params, eng = make_engine(slots=2, arch="whisper_small")
    rng = np.random.default_rng(0)
    for i, p in enumerate(_traffic(cfg.vocab, 3)):
        eng.submit(Request(i, p, max_new_tokens=4, frames=rng.standard_normal(
            (cfg.enc_seq, cfg.d_model)).astype(np.float32)))
    done = eng.run_to_completion()
    assert done.completed and len(done) == 3
    assert all(0 <= t < cfg.vocab for r in done for t in r.out_tokens)
    assert eng.enc_out.shape == (2, cfg.enc_seq, cfg.d_model)
    assert eng.enc_out.any()


def test_launcher_serves_on_the_cpu(capsys):
    serve_main.main(["--arch", "qwen2_moe_a2_7b", "--smoke", "--device",
                     "cpu", "--requests", "5", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert out.startswith("served 5 requests, 20 tokens")
    assert "on cpu" in out
