"""Batched serving engine: slot-based continuous batching over the
registry models' prefill/decode surface.

Port of ``repro/serve/engine.py``. The engine mirrors the Sphere
client's role (paper §3.4): it orchestrates, the decode step is the SPE.
Requests are segments; a fixed number of batch *slots* bounds the working
set exactly like the scheduler's segment capacity clamp; finished slots
are refilled from the queue each step (continuous batching). An enc-dec
model (``audio``) encodes a request's ``frames`` once, when its slot is
refilled, into the slot's row of the engine's encoder memory, which every
decode batch carries.

The caches are the model's: a layer-stacked dict, or a list of per-layer
dicts (heterogeneous stacks); a refilled slot's rows of every leaf are
reset (positions to -1, everything else to 0). Prompts are fed token by
token through the full-batch decode, as the JAX engine does, so every
*other* slot takes a step at its next position with token 0: an
attention cache has that entry overwritten by the slot's own next
decode, but a recurrent state (Mamba2, mLSTM, sLSTM) keeps the phantom
step. The port reproduces this, so its token streams equal the JAX
engine's.

The decode runs eagerly (no compiled step) under
``torch.inference_mode()``, on the device of the model's parameters; the
caches are written in place. Sampling at ``temperature > 0`` draws from
the engine's own ``torch.Generator(seed)``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import encdec
from repro_torch.models.registry import Model
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray                 # (S,) int32 decoder/prompt tokens
    max_new_tokens: int = 16
    #: enc-dec models: (enc_seq, d_model) frame embeddings (stub frontend
    #: output) to be encoded once at admission
    frames: Optional[np.ndarray] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: multi-tenant admission (only read when the engine has a tenant
    #: queue): which tenant the request bills to, and its queue-wait
    #: deadline in engine steps (None = no deadline)
    tenant: str = "default"
    timeout: Optional[float] = None


class ServeReport(list):
    """``run_to_completion`` result: iterates/len()s as the list of finished
    requests, plus the work that did NOT finish within ``max_steps``."""

    def __init__(self, done: List[Request], unfinished: List[Request]):
        super().__init__(done)
        self.unfinished = unfinished

    @property
    def completed(self) -> bool:
        return not self.unfinished


class ServeEngine:
    def __init__(self, model: Model, params, batch_slots: int = 4,
                 max_len: int = 256, temperature: float = 0.0, seed: int = 0,
                 tenants=None, trace: Optional[Any] = None):
        """``tenants``: optional
        :class:`repro_torch.sphere.streaming.TenantQueue` (duck-typed).
        When given, the continuous-batching refill pulls from it instead of
        the plain FIFO: slot refills follow priority classes and weighted
        fair share, queue-waits past a request's deadline requeue it
        (bounded retries), and ``submit`` raises
        :class:`repro_torch.sphere.streaming.QueueFull` as backpressure.
        Engine time is the step counter, so deadlines are in steps.

        ``trace``: a :class:`repro_torch.obs.trace.Tracer`; each engine
        iteration becomes a ``serve.step[i]`` span annotated with active
        slots and tokens emitted."""
        self.model = model
        self.trace = trace if trace is not None else NULL_TRACER
        self.params = params
        self.device = params.embed.device
        self.slots = batch_slots
        self.max_len = max_len
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.queue: deque[Request] = deque()
        self.tenants = tenants
        self.step_count = 0
        self._tickets: Dict[int, object] = {}   # req_id -> Ticket
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.pos = np.zeros((batch_slots,), np.int32)
        self.caches = model.init_caches(batch_slots, max_len,
                                        device=self.device)
        self._batch_axes = self._find_batch_axes()
        self.enc_dec = model.cfg.family == "audio"
        if self.enc_dec:
            # per-slot encoder output (cross-attention memory)
            self.enc_out = torch.zeros(
                (batch_slots, model.cfg.enc_seq, model.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)

    def _find_batch_axes(self):
        """Per-cache-leaf batch axis, found structurally: the axis whose
        size changes between init_caches(slots) and init_caches(slots+1),
        both built on the ``meta`` device (shapes only). Size matching is
        ambiguous (num_layers can equal batch_slots). The caches' layout:
        ``{name: axis}`` for a dict, a list of those for a list."""
        a = self.model.init_caches(self.slots, self.max_len, device="meta")
        b = self.model.init_caches(self.slots + 1, self.max_len,
                                   device="meta")

        def axes(da, db):
            out = {}
            for name in da:
                diff = [i for i, (x, y) in enumerate(zip(da[name].shape,
                                                         db[name].shape))
                        if x != y]
                out[name] = diff[0] if diff else None
            return out
        if isinstance(a, dict):
            return axes(a, b)
        return [axes(da, db) for da, db in zip(a, b)]

    def submit(self, req: Request) -> None:
        if self.tenants is not None:
            tk = self.tenants.admit(req.tenant, req, cost=1,
                                    timeout=req.timeout,
                                    now=float(self.step_count))
            self._tickets[req.req_id] = tk
        else:
            self.queue.append(req)

    def _next_request(self) -> Optional[Request]:
        if self.tenants is not None:
            got = self.tenants.acquire(1, now=float(self.step_count))
            return got[0].payload if got else None
        return self.queue.popleft() if self.queue else None

    def _has_pending(self) -> bool:
        return (self.tenants.pending() > 0 if self.tenants is not None
                else bool(self.queue))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A pinned copy on the card (a copy from pageable memory would
        wait for the card first, so the host could not run ahead)."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _decode(self, tokens: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        batch = {"tokens": self._to_device(tokens),
                 "pos": self._to_device(pos)}
        if self.enc_dec:
            batch["enc_out"] = self.enc_out
        logits, self.caches = self.model.decode_step(self.params, self.caches,
                                                     batch)
        return logits

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Feed the prompt (all but its final token) through the decode path
        for the slot. The final prompt token is fed by the first ``step()``
        call, whose logits produce the first generated token — feeding the
        whole prompt here would duplicate the last token. Other slots receive
        a write at their next position, which the subsequent real decode
        overwrites in an attention cache; a recurrent state keeps it (see
        the module docstring). An enc-dec request's frames are encoded
        into the slot's encoder memory first."""
        if self.enc_dec:
            frames = torch.from_numpy(np.asarray(req.frames, np.float32)).to(
                self.device).to(torch.bfloat16)[None]
            self.enc_out[slot] = encdec.encode(self.params, self.model.cfg,
                                               frames)[0]
        for t, tok in enumerate(req.prompt[:-1]):
            tokens = np.zeros((self.slots, 1), np.int32)
            tokens[slot, 0] = int(tok)
            pos = self.pos[:, None].astype(np.int32)
            pos[slot, 0] = t
            self._decode(tokens, pos)
        self.pos[slot] = len(req.prompt) - 1

    def step(self) -> List[Request]:
        """One engine iteration: refill slots, decode one token for every
        active slot, emit finished requests."""
        tr = self.trace
        with tr.span(f"serve.step[{self.step_count + 1}]") as sp:
            with torch.inference_mode():
                finished = self._step()
            active = sum(r is not None for r in self.active)
            if tr.enabled:
                sp.set(active_slots=active, finished=len(finished))
            if active or finished:
                REGISTRY.counter("serve.steps").inc()
                # every slot active during decode emitted one token,
                # including the ones that finished on it
                REGISTRY.counter("serve.tokens").inc(active + len(finished))
            if finished:
                REGISTRY.counter("serve.finished").inc(len(finished))
        return finished

    def _step(self) -> List[Request]:
        self.step_count += 1
        if self.tenants is not None:
            self.tenants.expire(float(self.step_count))
        # refill
        for s in range(self.slots):
            if self.active[s] is None:
                req = self._next_request()
                if req is None:
                    continue
                self.pos[s] = 0
                self._reset_slot_cache(s)
                self._prefill_into_slot(s, req)
                self.active[s] = req

        if not any(self.active):
            return []

        tokens = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is not None:
                last = req.out_tokens[-1] if req.out_tokens else \
                    int(req.prompt[-1])
                tokens[s, 0] = last
        logits = self._decode(tokens, self.pos[:, None].astype(np.int32))
        logits = logits[:, 0].float()
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            drawn = torch.multinomial(probs, 1, generator=self.generator)
            nxt_all = drawn[:, 0].tolist()
        else:
            nxt_all = torch.argmax(logits, dim=-1).tolist()

        finished: List[Request] = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            nxt = int(nxt_all[s])
            req.out_tokens.append(nxt)
            self.pos[s] += 1
            if len(req.out_tokens) >= req.max_new_tokens or \
                    self.pos[s] >= self.max_len - 1:
                req.done = True
                finished.append(req)
                self.active[s] = None
                if self.tenants is not None:
                    tk = self._tickets.pop(req.req_id, None)
                    if tk is not None:
                        self.tenants.complete(tk, now=float(self.step_count))
        return finished

    def _reset_slot_cache(self, slot: int) -> None:
        """Every leaf's rows of ``slot``: int32 position maps to -1 (empty),
        every other leaf to 0, as the JAX engine does: sLSTM's ``n`` too,
        though ``slstm_init_cache`` starts it at 1."""
        if isinstance(self.caches, dict):
            pairs = [(self.caches, self._batch_axes)]
        else:
            pairs = list(zip(self.caches, self._batch_axes))
        for cache, axes in pairs:
            for name, leaf in cache.items():
                ax = axes[name]
                if ax is None:
                    continue
                fill = -1 if leaf.dtype == torch.int32 else 0
                leaf.select(ax, slot).fill_(fill)

    def run_to_completion(self, max_steps: int = 10_000) -> ServeReport:
        """Step until queue and slots drain, or ``max_steps``. The report
        lists finished requests (it IS that list) *and* whatever was still
        queued or mid-generation when the step budget ran out."""
        done: List[Request] = []
        for _ in range(max_steps):
            done.extend(self.step())
            if not self._has_pending() and not any(self.active):
                break
        unfinished = [r for r in self.active if r is not None]
        if self.tenants is not None:
            unfinished += [tk.payload for tk in self.tenants.pending_items()]
        else:
            unfinished += list(self.queue)
        return ServeReport(done, unfinished)
