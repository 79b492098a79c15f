"""Real-execution serving engine of the port: ORLOJ scheduling over the
PyTorch model, with batch times measured on the card.

The counterpart of :mod:`repro.serving.engine`, with the same public API
and contracts: variable-length requests → Orloj (or baseline) scheduler →
padded batch (bucketed shapes) → measured execution feeds the online
profiler; time is hybrid (the clock advances by measured execution and
skips idle gaps).  Prefill attention runs the flash-attention kernel and
the decode step the decode-attention kernel, both hand-written for Hopper.

Timing: inputs are copied to the device before the clock starts, and the
clock stops after ``torch.cuda.synchronize()`` (PyTorch returns before the
card finishes).  The first run of each shape is a warm-up outside the
timed region; it is where the kernels are built.

Each served shape runs as one program, the counterpart of the reference's
per-shape ``jax.jit``: on a CUDA device the first use of a padded
``(k, bucket)`` shape, and the decode executor's construction, capture the
forward (the decode step) into a CUDA graph over static input buffers, and
every measured run copies its inputs into those buffers and replays the
graph.  On the CPU the same body runs eagerly.  There is no switch and no
fallback: a capture or replay that fails raises.  A graph reads the
parameter tensors it captured, so an executor's ``params`` are fixed once
it is built (:attr:`TorchExecutor.params` is read-only; updating the
tensors in place is seen by the graphs).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.distributions import BatchLatencyModel
from ..core.eventloop import SimResult, Worker, run_event_loop, simulate
from ..core.request import Request
from ..core.scheduler import Batch
from ..core.spans import ENGINE_FIT, EXEC_CAPTURE, EXEC_H2D, EXEC_PAD, EXEC_REPLAY, SpanLog
from ..device import resolve_device
from ..kernels import ops
from ..models import Model, ModelConfig, hymba
from .batcher import bucket_for, make_padded_batch, padded_batch_size
from .faults import FaultPlan
from .trace import offered_rate

__all__ = ["EngineConfig", "TorchExecutor", "DecodeTorchExecutor", "TorchServingEngine"]

Params = dict


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    buckets: tuple[int, ...] = (32, 64, 128, 256)
    batch_sizes: tuple[int, ...] = (1, 2, 4, 8)
    profile_reps: int = 3
    # When > 0, a batch whose measured execution exceeds this is aborted
    # at the timeout and its requests go through the fault tier's
    # deadline-aware retry gate — the real engine's defense against a
    # pathological straggler batch wedging the worker.
    batch_timeout_ms: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Program:
    """One served shape's program: ``fn``, which reads only tensors that
    outlive it (static inputs, parameters) and returns its output.

    On a CUDA device ``fn`` is warmed up once on ``stream`` (where the
    kernels are built and cuBLAS takes its workspace for the stream), then
    captured into a CUDA graph whose memory comes from ``pool``; calling the
    program replays the graph on ``stream`` and returns the graph's static
    output, which the next replay overwrites.  The capture's kernel calls
    launch nothing, so their launch counts are taken back and added again
    at each replay (:func:`ops.captured_launches`).  The cyclic garbage
    collector is off during the capture: a graph of an executor dropped
    earlier, freed by a collection in the middle of a capture, would free
    device memory, which a capturing stream refuses, and the capture would
    fail; such garbage waits for the next collection outside a capture.
    On the CPU the warm-up runs ``fn`` once and each call runs it
    eagerly."""

    def __init__(self, fn: Callable[[], torch.Tensor], device: torch.device,
                 stream: torch.cuda.Stream | None = None, pool=None):
        self.fn = fn
        self.graph = None
        if device.type != "cuda":
            fn()
            return
        self.stream = stream
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn()
        stream.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with ops.captured_launches() as self.launches, torch.cuda.graph(
                self.graph, pool=pool, stream=stream
            ):
                self.out = fn()
        finally:
            if collecting:
                gc.enable()

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            return self.fn()
        with torch.cuda.stream(self.stream):
            self.graph.replay()
        ops.add_launches(self.launches)
        return self.out


class TorchExecutor:
    """Executor for the simulator loop that runs the real model and returns
    the *measured* batch execution time (ms).

    Each padded ``(k, bucket)`` shape gets a static token buffer and a
    :class:`_Program` at its first use: on a CUDA device a graph of the
    forward, captured on the executor's stream into the memory pool that
    all its graphs share (one graph runs at a time).  Every graph's logits
    stay allocated: Σk·Σbucket·vocab·4 bytes over the configured shapes.
    :attr:`last_logits` holds the logits of the last run (on the card, the
    graph's static output of that shape).

    Every served batch is appended to :attr:`measured` as ``(padded_k,
    bucket, measured_ms)``; profiling calls go through :meth:`_run`
    directly and are not logged.  The log is a bounded ring
    (:data:`MEASURED_LOG_CAP` most recent batches); :meth:`drain_measured`
    reads and resets it around one serving run.

    :attr:`spans`, ``None`` unless a caller sets a
    :class:`~repro_torch.core.spans.SpanLog`, records each served batch's
    ``exec.pad`` (the padded batch, its rows padded to the batch size),
    every run's ``exec.h2d`` (the tokens' copy into the static buffer, up
    to the pre-replay synchronize) and ``exec.replay`` (the measured
    bracket), and a shape's first use as ``exec.capture``, in that order
    and without overlap."""

    MEASURED_LOG_CAP = 4096

    def __init__(self, model: Model, params: Params, cfg: EngineConfig):
        self.model = model
        self._params = params
        self.cfg = cfg
        self.device = model.device
        # padded shape -> (its static token buffer, its program)
        self._shapes: dict[tuple[int, int], tuple[torch.Tensor, _Program]] = {}
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        else:
            self._stream = self._pool = None
        self.measured: deque[tuple[int, int, float]] = deque(maxlen=self.MEASURED_LOG_CAP)
        self.spans: SpanLog | None = None

    @property
    def params(self) -> Params:
        """The parameters the programs read; read-only, since a captured
        graph keeps reading the tensors it was captured with."""
        return self._params

    @property
    def _warm(self):
        """The padded shapes whose program is ready (warmed up, captured)."""
        return self._shapes.keys()

    def drain_measured(self) -> list[tuple[int, int, float]]:
        """Return the ``(padded_k, bucket, measured_ms)`` log and reset it."""
        out = list(self.measured)
        self.measured.clear()
        return out

    def padded_batch_size(self, k: int) -> int:
        return padded_batch_size(k, self.cfg.batch_sizes)

    @torch.no_grad()
    def _forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.model.logits(self._params, {"tokens": tokens})

    def _pad(self, tokens: np.ndarray) -> np.ndarray:
        """``tokens`` with zero rows up to the padded batch size."""
        k = self.padded_batch_size(tokens.shape[0])
        if k > tokens.shape[0]:
            tokens = np.concatenate(
                [tokens, np.zeros((k - tokens.shape[0],) + tokens.shape[1:], tokens.dtype)]
            )
        return tokens

    def _capture(self, tokens: np.ndarray) -> None:
        """First run of a shape: the warm-up (where the kernels are built)
        and the capture, on the batch's own tokens, so that neither
        pollutes a measurement."""
        start = time.time_ns()
        static = torch.empty(tokens.shape, dtype=torch.int64, device=self.device)
        static.copy_(torch.from_numpy(np.ascontiguousarray(tokens, np.int64)))
        self._shapes[tokens.shape] = static, _Program(
            lambda: self._forward(static), self.device, self._stream, self._pool
        )
        if self.spans is not None:
            self.spans.add(EXEC_CAPTURE, start, time.time_ns())

    def _run(self, tokens: np.ndarray) -> tuple[float, int]:
        """Execute one padded batch; returns ``(measured_ms, padded_k)``.

        The padded batch size is what the card actually ran — the latency
        model must be fit against it (not the requested k)."""
        tokens = self._pad(tokens)
        key = tokens.shape
        if key not in self._shapes:
            self._capture(tokens)
        spans = self.spans
        copy_start = time.time_ns() if spans is not None else 0
        batch = torch.from_numpy(np.ascontiguousarray(tokens, np.int64))
        static, program = self._shapes[key]
        static.copy_(batch)
        _sync(self.device)
        replay_start = time.time_ns() if spans is not None else 0
        t0 = time.perf_counter()
        self.last_logits = program()
        _sync(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        if spans is not None:
            spans.add(EXEC_H2D, copy_start, replay_start)
            spans.add(EXEC_REPLAY, replay_start, time.time_ns())
        return ms, key[0]

    def __call__(self, batch: Batch, now: float) -> float:
        spans = self.spans
        start = time.time_ns() if spans is not None else 0
        # Admission (make_requests) caps lengths at the largest bucket, so
        # overflow here is a programming error — fail loudly.
        padded = make_padded_batch(batch.requests, self.cfg.buckets, overflow="error")
        tokens = self._pad(padded.tokens)
        if spans is not None:
            spans.add(EXEC_PAD, start, time.time_ns())
        ms, k_pad = self._run(tokens)
        self.measured.append((k_pad, padded.labels_bucket, ms))
        return ms


class DecodeTorchExecutor:
    """Measured decode-step executor for the continuous-batching loop: one
    token step of the running batch = one decode-attention kernel launch
    over a ring-buffer KV cache, timed on the card.

    Mirrors :class:`repro.serving.engine.DecodeJaxExecutor`: a fixed
    ``(max_batch, n_kv_heads, max_cache, head_dim)`` float32 cache plus
    per-slot ``valid_len``; requests claim slots on join and free them
    when they leave the active set (reconciled by ``rid``); empty slots
    ride along with ``valid_len == 0`` and come out as zero rows.  The
    values (queries, cache contents, prompt tokens) are seeded synthetic,
    drawn from numpy in the reference's order, so :attr:`last_out` equals
    the reference's for a seed.

    Unlike the reference, the state is updated in place: the caches,
    ``valid_len`` and the step's queries and new K/V are static tensors,
    which the step (a :class:`_Program`, so on the card one CUDA graph,
    captured at construction after the warm-up step) reads and writes.
    Assigning :attr:`_valid` copies into its tensor.  One quirk is kept on
    purpose: once ``valid_len`` reaches ``max_cache``, ``pos = valid %
    max_cache`` sends every write to slot 0.

    A Hymba configuration (:class:`repro_torch.models.HymbaConfig`) with
    meta tokens keeps their K/V in ``n_meta_tokens`` fixed slots in front
    of the ring, the same for every request (the meta tokens come first, so
    no prompt reaches them), which every active row attends besides its
    ring slots; with ``kv_share`` a step launches the kernel twice over the
    one cache, a second layer's queries reading the K/V the first wrote.

    On a CUDA device the step always launches the kernel; the plain
    version runs only for a CPU device."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        *,
        max_batch: int = 8,
        max_cache: int = 256,
        prefill: TorchExecutor | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        if max_batch <= 0 or max_cache <= 0:
            raise ValueError(
                f"max_batch and max_cache must be positive, got {max_batch} and {max_cache}"
            )
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_cache = max_cache
        self.n_heads = model_cfg.n_heads
        self.n_kv = model_cfg.n_kv_heads
        self.head_dim = model_cfg.head_dim or model_cfg.d_model // model_cfg.n_heads
        self.prefill = prefill
        self.prefix = hymba.options(model_cfg).n_meta_tokens
        self.readers = 2 if hymba.options(model_cfg).kv_share else 1
        self._rng = np.random.default_rng(seed)
        self._slot: dict[int, int] = {}  # rid -> cache slot
        self._free = list(range(max_batch - 1, -1, -1))
        b, kv, hd = max_batch, self.n_kv, self.head_dim

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        slots = self.prefix + max_cache
        self._kc, self._vc = zeros(b, kv, slots, hd), zeros(b, kv, slots, hd)
        self._valid_len = zeros(b, dtype=torch.int32)
        self._q, self._nk, self._nv = zeros(b, self.n_heads, hd), zeros(b, kv, hd), zeros(b, kv, hd)
        self._queries = [self._q] + [zeros(b, self.n_heads, hd) for _ in range(self.readers - 1)]
        self._rows = torch.arange(b, device=self.device)
        if self.prefix:  # the meta tokens' K/V, one set for every slot
            meta = self._rng.standard_normal((2, kv, self.prefix, hd)).astype(np.float32)
            meta = torch.from_numpy(meta).to(self.device)
            self._kc[:, :, : self.prefix] = meta[0]
            self._vc[:, :, : self.prefix] = meta[1]
        # The warm-up step (it builds the kernel), as the reference warms
        # its jit, then the capture.
        self._draw()
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._program = _Program(self._step, self.device, stream)

    @property
    def _valid(self) -> torch.Tensor:
        """Each slot's valid length, (max_batch,) int32; assigning copies."""
        return self._valid_len

    @_valid.setter
    def _valid(self, value) -> None:
        self._valid_len.copy_(value)

    # ------------------------------------------------------------ internals
    @torch.no_grad()
    def _step(self) -> torch.Tensor:
        """Write this step's K/V at each active slot's ring position,
        advance ``valid_len``, attend.  Inactive slots keep their cache and
        attend over zero valid positions."""
        valid = self._valid_len
        active = valid > 0
        pos = (valid % self.max_cache).long() + self.prefix
        sel = active[:, None, None]
        rows = self._rows
        self._kc[rows, :, pos, :] = torch.where(sel, self._nk, self._kc[rows, :, pos, :])
        self._vc[rows, :, pos, :] = torch.where(sel, self._nv, self._vc[rows, :, pos, :])
        valid.copy_(torch.where(active, torch.clamp(valid + 1, max=self.max_cache), valid))
        attend = torch.where(valid > 0, valid + self.prefix, valid) if self.prefix else valid
        outs = [ops.decode_attention(q, self._kc, self._vc, attend) for q in self._queries]
        return outs[0] if len(outs) == 1 else torch.cat(outs, 1)

    def _draw(self) -> None:
        """Draw this step's synthetic queries and new K/V (the reference's
        order) into their static tensors."""
        for t in (*self._queries, self._nk, self._nv):
            t.copy_(torch.from_numpy(self._rng.standard_normal(tuple(t.shape)).astype(np.float32)))

    def _decode_once(self) -> float:
        """One measured decode step at full capacity (ms); mutates the
        cache state of the active slots."""
        # Synthetic values are drawn and copied to the card OUTSIDE the
        # timed region: the measurement prices the step, not host-side rng.
        self._draw()
        _sync(self.device)
        t0 = time.perf_counter()
        out = self._program()
        _sync(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        # (B, H, hd) attention output of the last step — synthetic-valued,
        # kept for kernel-integration tests and debugging (on the card, the
        # graph's static output).
        self.last_out = out
        return ms

    @torch.no_grad()
    def _prefill_ms(self, joined: Sequence[Request]) -> float:
        """Price the joined prompts through the padded prefill forward and
        seed their cache slots.  Without a prefill executor the forward is
        skipped (decode-only pricing) but slots are still seeded."""
        ms = 0.0
        lens = [max(int(r.prompt_tokens), 1) for r in joined]
        if self.prefill is not None:
            bucket = bucket_for(
                min(max(lens), max(self.prefill.cfg.buckets)), self.prefill.cfg.buckets
            )
            toks = np.zeros((len(joined), bucket), np.int32)
            for i, l in enumerate(lens):
                n_tok = min(l, bucket)
                toks[i, :n_tok] = self._rng.integers(1, 1000, size=n_tok)
            ms, _ = self.prefill._run(toks)
        for r, l in zip(joined, lens):
            if not self._free:
                raise RuntimeError(
                    f"decode executor capacity exceeded: {len(self._slot)} "
                    f"active slots of {self.max_batch}; the token scheduler "
                    f"must admit at most max_batch concurrent requests"
                )
            slot = self._free.pop()
            self._slot[r.rid] = slot
            n_ctx = min(l, self.max_cache)
            kv = self._rng.standard_normal((2, self.n_kv, n_ctx, self.head_dim)).astype(np.float32)
            kv = torch.from_numpy(kv).to(self.device)
            ring = slice(self.prefix, self.prefix + n_ctx)
            self._kc[slot, :, ring, :] = kv[0]
            self._vc[slot, :, ring, :] = kv[1]
            self._valid[slot] = n_ctx
        return ms

    def _release_departed(self, active: Sequence[Request]) -> None:
        live = {r.rid for r in active}
        for rid in [r for r in self._slot if r not in live]:
            slot = self._slot.pop(rid)
            self._valid[slot] = 0
            self._free.append(slot)

    # ------------------------------------------------------------- API
    def calibrate(self, reps: int = 3) -> float:
        """Median measured decode-step ms at *full* batch capacity — the
        request-generation rate anchor (cache state is restored)."""
        saved = [t.clone() for t in (self._kc, self._vc, self._valid_len)]
        self._valid_len.fill_(self.max_cache)
        ts = [self._decode_once() for _ in range(reps)]
        for t, old in zip((self._kc, self._vc, self._valid_len), saved):
            t.copy_(old)
        return float(np.median(ts))

    def step_time(self, active: Sequence[Request], joined: Sequence[Request], now: float) -> float:
        """Measured ms for one token step: joined prompts' prefill plus
        the full-capacity decode attention step."""
        if not active:
            raise ValueError("step_time called with an empty active set")
        # Departures first (frees slots), then joins (claims them).
        self._release_departed(active)
        ms = self._prefill_ms(joined) if joined else 0.0
        return ms + self._decode_once()


@dataclasses.dataclass
class _ScaledExecutor:
    """A replica whose hardware is ``scale``× slower than the measured
    backend: the shared executor runs the batch for real, and the measured
    duration is scaled before it reaches the virtual clock."""

    inner: TorchExecutor
    scale: float

    def __call__(self, batch: Batch, now: float) -> float:
        return self.scale * self.inner(batch, now)


class TorchServingEngine:
    """Profiles the model's Eq.-3 latency curve, generates length-driven
    requests, and runs any scheduler against real execution on the card.

    **Determinism contract** (as the reference's): everything upstream of
    execution is seeded — model parameters from ``seed`` through a
    ``torch.Generator`` (or passed in as ``params``, e.g. converted from
    the reference with :func:`repro_torch.models.convert.from_numpy`),
    request generation from the ``seed`` of :meth:`make_requests` — so two
    engines with the same config and seed serve identical batches.  The
    measured durations are real and machine-dependent."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        cfg: EngineConfig | None = None,
        seed: int = 0,
        *,
        device: str | torch.device = "cuda",
        params: Params | None = None,
    ):
        self.cfg = cfg or EngineConfig()
        self.seed = seed
        self.model = Model(model_cfg, device=device)
        self.device = self.model.device
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        self.params = params
        self.executor = TorchExecutor(self.model, self.params, self.cfg)

    def executor_for(self, scale: float = 1.0) -> TorchExecutor | _ScaledExecutor:
        """Executor factory for pool construction: ``scale == 1`` returns
        the shared measured executor; ``scale > 1`` wraps it so the replica
        appears ``scale``× slower (heterogeneous pools, one real backend)."""
        if scale == 1.0:
            return self.executor
        if scale <= 0.0:
            raise ValueError(f"executor scale must be positive, got {scale}")
        return _ScaledExecutor(self.executor, scale)

    # -------------------------------------------------------- profiling
    def profile_latency_model(self) -> BatchLatencyModel:
        """Fit Eq. 3 (l_B = c0 + c1·k·l) from the measured (k, bucket) grid;
        l is the padded bucket length in tokens, c1 converts tokens → ms.
        With the executor's span log set, the whole fit is ``engine.fit``."""
        start = time.time_ns()
        xs, ys = [], []
        for bucket in self.cfg.buckets:
            for k in sorted(set(self.cfg.batch_sizes)):
                toks = np.ones((k, bucket), np.int32)
                ts, k_pad = [], k
                for _ in range(self.cfg.profile_reps):
                    ms, k_pad = self.executor._run(toks)
                    ts.append(ms)
                xs.append((k_pad, bucket))
                ys.append(float(np.median(ts)))
        a = np.array([[1.0, k * l] for k, l in xs])
        coef, *_ = np.linalg.lstsq(a, np.array(ys), rcond=None)
        c0, c1 = float(max(coef[0], 0.01)), float(max(coef[1], 1e-6))
        if self.executor.spans is not None:
            self.executor.spans.add(ENGINE_FIT, start, time.time_ns())
        return BatchLatencyModel(c0=c0, c1=c1, bucket=0.0)

    # ------------------------------------------------------ request gen
    def make_requests(
        self,
        n: int,
        lm: BatchLatencyModel,
        *,
        length_sampler: Callable[[np.random.Generator], int],
        slo_scale: float = 3.0,
        utilization: float = 0.7,
        seed: int = 0,
    ) -> tuple[list[Request], dict]:
        """Length-driven requests: the execution-time 'distribution' is the
        real consequence of the token-length distribution.  true_time is
        the request's intrinsic size in c1-units (= padded token count), so
        Eq. 3 reproduces measured latency."""
        rng = np.random.default_rng(seed)
        lengths = np.array([length_sampler(rng) for _ in range(n)])
        # Admission control: the serving path cannot represent payloads
        # beyond the largest bucket, so cap lengths here (explicitly, once).
        lengths = np.minimum(lengths, max(self.cfg.buckets))
        sizes = np.array([bucket_for(int(l), self.cfg.buckets) for l in lengths], np.float64)
        alone = lm.c0 + lm.c1 * sizes
        p99 = float(np.quantile(alone, 0.99))
        slo = slo_scale * p99

        rate = offered_rate(sizes, lm, utilization, self.cfg.batch_sizes[-1], rng)
        gaps = rng.exponential(1.0 / rate, size=n)
        arrivals = np.cumsum(gaps)

        reqs = []
        for i in range(n):
            tok = rng.integers(1, 1000, size=int(lengths[i])).astype(np.int32)
            reqs.append(
                Request(
                    app_id="short" if lengths[i] <= np.median(lengths) else "long",
                    release=float(arrivals[i]),
                    slo=slo,
                    true_time=float(sizes[i]),
                    payload=tok,
                )
            )
        hist = {
            "short": sizes[lengths <= np.median(lengths)],
            "long": sizes[lengths > np.median(lengths)],
        }
        return reqs, hist

    def decode_executor(
        self, *, max_batch: int = 8, max_cache: int = 256, seed: int | None = None
    ) -> DecodeTorchExecutor:
        """Build a :class:`DecodeTorchExecutor` over this engine's model
        dims on its device, wired to the shared measured prefill executor."""
        return DecodeTorchExecutor(
            self.model.cfg,
            max_batch=max_batch,
            max_cache=max_cache,
            prefill=self.executor,
            seed=self.seed if seed is None else seed,
            device=self.device,
        )

    def make_token_requests(
        self,
        n: int,
        decode: DecodeTorchExecutor,
        *,
        mean_out: float = 24.0,
        tpot_scale: float = 2.0,
        ttft_mult: float = 8.0,
        utilization: float = 0.7,
        prompt_lo: int = 16,
        prompt_hi: int = 128,
        seed: int = 0,
    ) -> list[Request]:
        """Token-mode requests anchored to the *measured* decode step:
        geometric output lengths (mean ``mean_out``), uniform prompts,
        TPOT SLO = ``tpot_scale`` × the calibrated full-batch step time,
        TTFT = ``ttft_mult`` × TPOT, arrival rate offering ``utilization``
        of a worker continuously batching at capacity."""
        step_ms = decode.calibrate()
        tpot = tpot_scale * step_ms
        ttft = ttft_mult * tpot
        rng = np.random.default_rng(seed)
        out = np.maximum(rng.geometric(1.0 / mean_out, size=n), 1)
        prompts = rng.integers(prompt_lo, prompt_hi + 1, size=n)
        rate = utilization * decode.max_batch / (step_ms * mean_out)
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
        return [
            Request(
                app_id="tok",
                release=float(t),
                slo=ttft + tpot * (float(o) - 1.0),
                true_time=float(o) * step_ms,
                prompt_tokens=int(p),
                out_tokens=int(o),
            )
            for t, o, p in zip(arrivals, out, prompts)
        ]

    # ------------------------------------------------------------- run
    def serve_tokens(
        self,
        requests: Sequence[Request],
        scheduler,
        decode: DecodeTorchExecutor,
        *,
        engine: str = "scalar",
    ) -> SimResult:
        """Serve a token-mode request set through the continuous-batching
        loop with measured decode steps.  The scheduler must be a token
        scheduler (``repro_torch.core.tokensched``) whose ``max_batch``
        does not exceed the executor's slot capacity."""
        cap = getattr(getattr(scheduler, "cfg", None), "max_batch", None)
        if cap is not None and cap > decode.max_batch:
            raise ValueError(
                f"scheduler admits up to {cap} concurrent requests but the "
                f"decode executor has only {decode.max_batch} cache slots"
            )
        return run_event_loop(list(requests), [Worker(scheduler, decode)], engine=engine)

    def serve(self, requests: Sequence[Request], scheduler) -> SimResult:
        faults = None
        if self.cfg.batch_timeout_ms > 0.0:
            faults = FaultPlan(batch_timeout_ms=self.cfg.batch_timeout_ms)
        return simulate(list(requests), scheduler, self.executor, faults=faults)

    def serve_pool(
        self,
        requests: Sequence[Request],
        schedulers: Sequence,
        policy: str = "least_loaded",
        seed: int = 0,
        horizon: float | None = None,
        charge_scheduler_overhead: bool = False,
        executors: Sequence | None = None,
    ) -> SimResult:
        """Serve one arrival stream across N replica schedulers (§3.1).

        By default all replicas share this engine's measured executor (one
        physical backend timed once per batch); pass ``executors`` (one per
        scheduler, e.g. from :meth:`executor_for`) for a heterogeneous pool
        of fast and scaled-slow replicas."""
        if executors is None:
            executors = [self.executor] * len(schedulers)
        if len(executors) != len(schedulers):
            raise ValueError(f"got {len(schedulers)} schedulers but {len(executors)} executors")
        return run_event_loop(
            list(requests),
            [Worker(s, e) for s, e in zip(schedulers, executors)],
            policy=policy,
            seed=seed,
            horizon=horizon,
            charge_scheduler_overhead=charge_scheduler_overhead,
        )
