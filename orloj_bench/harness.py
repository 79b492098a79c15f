"""One run of one cell: set-up, the window through the program's own event
loop, the counting, the metrics and the check against the reference.

What the program under test contributes is ``repro_torch``'s serving engine
(its ``TorchExecutor`` replays each padded shape as a CUDA graph), its
Eq.-3 fit, its ``OrlojScheduler`` and its event loop, and in a traced run
its span log and its graphs' launch counters.  Everything else is the
benchmark's: the weights, the arrivals, the clock around each batch, the
counting, the trace's reduction and the reference.  What differs between
model families (the program's configuration, the weights' layout, the work
of a batch, the reference) is the family's: ``families/<block_pattern>.py``
and ``reference/<block_pattern>.py``.

The window.  ``run_event_loop`` runs one ``Worker(scheduler, executor)``
with ``charge_scheduler_overhead=True`` until its virtual clock passes
``--seconds``.  The clock advances by each batch's time, which the
benchmark's wrapper around the program's executor measures on the host
(from the batch's padding to the program's ``synchronize``), plus the
scheduler's measured decision time, and skips the gaps in which nothing is
queued: the card works through the window.  The loop's own wall-clock
budget is not used: it is looked at once every 1,024 events, more than a
window of GLM-4-9B's batches holds.

Counting.  ``T_end`` is the virtual time the loop reached.  The requests
released at or before ``T_end − slo`` are counted (``attempted``), so each
one's deadline lies inside the window.  A counted request that finished by
its deadline is met; one dropped, late, or unresolved at ``T_end`` is a
miss.  ``failed`` counts only the counted requests that the program got
wrong or lost: its batch raised, its logits failed the comparison, or the
loop's accounting lost it (``SimResult.conserved`` false).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import families, reference, traffic
from .weights import make_weights, port_params

ROOT = Path(__file__).resolve().parent
BENCH_FILE = ROOT.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    mix: dict
    checks: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else json.loads(BENCH_FILE.read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((ROOT.parent / cfg_entry["file"]).read_text())
    need = [str(p.relative_to(ROOT.parent)) for p in families.files(cfg["block_pattern"])]
    missing = [p for p in need if not (ROOT.parent / p).exists()]
    if missing:
        raise SystemExit(f"configuration {entry['config']!r} has block_pattern "
                         f"{cfg['block_pattern']!r}, which needs {' and '.join(need)}; "
                         f"missing: {', '.join(missing)}")
    engine_fields(cfg)
    tr = traffic.load("traffic", entry["traffic"])
    return Cell(
        name=name,
        config=cfg,
        traffic=tr,
        mix=traffic.load("mixes", tr["mix"]),
        checks=traffic.load("checks", entry["config"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def model_config(cfg: dict):
    """The program's ``ModelConfig`` from the configuration's file, by its
    family."""
    return families.of(cfg).model_config(cfg)


ENGINE_KEYS = ("buckets", "batch_sizes")


def engine_fields(cfg: dict) -> dict:
    """The configuration's ``engine`` key: the served shapes, ``buckets``
    and ``batch_sizes``, and nothing else.  Any other field of the
    program's ``EngineConfig`` (its fit's repetitions, its batch timeout)
    would change how the program serves without a benchmark file showing
    it, and is refused."""
    fields = cfg.get("engine", {})
    other = sorted(set(fields) - set(ENGINE_KEYS))
    if other:
        raise SystemExit(f"configuration {cfg['name']!r} sets engine {', '.join(other)}; "
                         f"a configuration's engine may set only {' and '.join(ENGINE_KEYS)}")
    return {k: tuple(v) for k, v in fields.items()}


def engine_config(cfg: dict):
    """The program's ``EngineConfig``: its defaults (buckets 32–256, batches
    1–8), or the served shapes in the configuration file's ``engine``."""
    from repro_torch.serving.engine import EngineConfig

    return EngineConfig(**engine_fields(cfg))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CheckedExecutor:
    """The program's executor, timed by the benchmark, with a seeded sample of
    the served requests' logits kept for the check.

    Each call is timed on the host from the batch's padding to the program's
    closing ``synchronize``; that time is what the loop's clock advances by.
    The sample is a reservoir of ``keep`` requests over every request served,
    drawn from the seed, plus the longest request served; each kept
    request's logits over its own prompt positions are copied on the device
    after the timed part."""

    def __init__(self, inner, seed: int, keep: int):
        self.inner = inner
        self.keep = keep
        self._rng = np.random.default_rng([seed, 11])
        self.n_seen = 0
        self.reservoir: list[tuple] = []
        self.longest: tuple | None = None
        self.batches: list[dict] = []
        self.spans: list[tuple[int, int, int]] = []  # (start_ns, mid_ns, end_ns)
        self.raised: set[int] = set()
        self.errors: list[str] = []

    def __call__(self, batch, now: float) -> float:
        s0 = time.time_ns()
        t0 = time.perf_counter()
        try:
            self.inner(batch, now)
        except Exception:  # the batch's requests are failed, the run goes on
            self.raised.update(r.rid for r in batch.requests)
            self.errors.append(traceback.format_exc(limit=4)[-1500:])
            return (time.perf_counter() - t0) * 1e3
        ms = (time.perf_counter() - t0) * 1e3
        s1 = time.time_ns()
        k_pad, bucket, inner_ms = self.inner.measured[-1]
        lengths = [len(r.payload) for r in batch.requests]
        self.batches.append({"k": len(lengths), "k_pad": k_pad, "bucket": bucket,
                             "lengths": lengths, "inner_ms": inner_ms, "ms": ms})
        self._sample(batch, self.inner.last_logits)
        self.spans.append((s0, s1, time.time_ns()))
        return ms

    def _sample(self, batch, logits: torch.Tensor) -> None:
        for row, r in enumerate(batch.requests):
            n = len(r.payload)
            if self.longest is None or n > len(self.longest[0].payload):
                self.longest = (r, logits[row, :n].clone())
            if len(self.reservoir) < self.keep:
                self.reservoir.append((r, logits[row, :n].clone()))
            else:
                j = int(self._rng.integers(0, self.n_seen + 1))
                if j < self.keep:
                    self.reservoir[j] = (r, logits[row, :n].clone())
            self.n_seen += 1

    def sample(self) -> list[tuple]:
        """The kept requests that the window finished, each once."""
        out, seen = [], set()
        for r, lg in self.reservoir + ([self.longest] if self.longest else []):
            if r.finished is not None and r.rid not in seen:
                seen.add(r.rid)
                out.append((r, lg))
        return out


@dataclasses.dataclass
class Run:
    """What the metric readers see.  ``spans`` is the program's span log
    (``repro_torch.core.spans.SpanLog``) of a traced run, from the Eq.-3 fit
    through the window, else ``None``; ``launches`` maps each padded shape
    (k, bucket) that the program captured as a graph to the kernel launches
    a replay of it counts (``_Program.launches``; none on the CPU, which
    captures no graph), which ``gemm_roofline`` holds against the family's
    products."""

    cell: Cell
    sim: object
    counted: list
    t_end_ms: float
    slo_ms: float
    batches: list[dict]
    lm: object
    setup_s: float
    failed: set[int]
    trace: object = None
    spans: object = None
    launches: dict = dataclasses.field(default_factory=dict)


def compare(cfg: dict, sample: list[tuple], w: dict) -> list[dict]:
    """Each kept request against the reference on the same tokens and the
    weights ``w`` (:func:`readings`)."""
    out = []
    for r, got in sample:
        ref = reference.logits(cfg, w, torch.from_numpy(np.asarray(r.payload)))
        out.append(readings(ref, got.to(ref.device)) | {"rid": r.rid, "len": len(r.payload)})
    return out


def readings(ref: torch.Tensor, got: torch.Tensor) -> dict:
    """Both over the reference logits' standard deviation σ: ``top_gap``, the
    widest gap by which a served (greedy) token's reference logit lies below
    the reference's best; ``logit_err``, the largest |got − ref|.  An error
    of at most ε·σ on every logit bounds the gap by 2ε·σ."""
    sigma = ref.std()
    served = got.argmax(-1)
    gap = ref.max(-1).values - ref.gather(-1, served[:, None])[:, 0]
    return {"top_gap": float(gap.max() / sigma), "logit_err": float((got - ref).abs().max() / sigma)}


def judge(rows: list[dict], limits: dict) -> tuple[dict, set[int]]:
    """The worst reading of each number over the kept requests, and the rids
    of those over a limit."""
    worst = {k: max((r[k] for r in rows), default=math.inf) for k in limits}
    bad = {r["rid"] for r in rows if any(r[k] > limits[k] for k in limits)}
    return worst, bad


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(f"orloj_bench_metric_{name}",
                                                  ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_requests(stream: traffic.Stream, buckets: tuple[int, ...]) -> list:
    from repro_torch.core.request import Request

    return [
        Request(app_id=app, release=float(t), slo=stream.slo_ms,
                true_time=float(traffic.bucket_of(len(p), buckets)), payload=p)
        for t, p, app in zip(stream.release_ms, stream.prompts, stream.apps)
    ]


def setup(cell: Cell, seed: int, device: torch.device, spans=None):
    """The engine on the seeded weights, the Eq.-3 fit (which warms and
    captures every served shape) → (engine, latency model, weights).  A
    span log ``spans`` is set on the executor before the fit."""
    from repro_torch.serving.engine import TorchServingEngine

    cfg = cell.config
    w = make_weights(cfg, seed, device)
    engine = TorchServingEngine(model_config(cfg), engine_config(cfg), seed=seed, device=device,
                                params=port_params(cfg, w))
    engine.executor.spans = spans
    lm = engine.profile_latency_model()
    _sync(device)
    return engine, lm, w


def window(cell: Cell, engine, lm, seed: int, seconds: float, trace: bool,
           device: torch.device, spans=None):
    """Serve one window → (sim result, requests, executor, trace or None),
    the loop recording into the span log ``spans`` where one is given."""
    from repro_torch.core.eventloop import Worker, run_event_loop
    from repro_torch.launch.serve import make_scheduler

    buckets = engine.cfg.buckets
    horizon = seconds * 1e3
    stream = traffic.make_stream(cell.traffic, cell.mix, seed, horizon, buckets)
    sched = make_scheduler("orloj", lm, stream.warm, engine.cfg.batch_sizes)
    requests = make_requests(stream, buckets)
    exe = CheckedExecutor(engine.executor, seed, cell.checks["sample"])
    engine.executor.drain_measured()
    _sync(device)
    rec = None
    if trace:
        from .trace import Recorder

        rec = Recorder()
    sim = run_event_loop(requests, [Worker(sched, exe)], horizon=horizon,
                         charge_scheduler_overhead=True, spans=spans)
    _sync(device)
    tr_out = rec.stop() if rec is not None else None
    if sim.makespan_ms < horizon:
        raise RuntimeError(f"the arrivals ran out at {sim.makespan_ms} ms of {horizon}")
    return sim, requests, exe, tr_out


def count(requests: list, t_end_ms: float, slo_ms: float) -> list:
    """The requests whose deadline lies inside the window."""
    return [r for r in requests if r.release <= t_end_ms - slo_ms]


def tally(requests: list, sim, slo_ms: float, wrong: set[int]) -> tuple[list, set[int], int]:
    """(counted requests, the rids of the counted ones the program got wrong,
    the number the loop's accounting lost).  ``wrong`` holds the rids whose
    batch raised or whose logits failed the comparison; drops and late or
    unresolved requests are misses, never failures."""
    counted = count(requests, sim.makespan_ms, slo_ms)
    lost = 0 if sim.conserved else abs(
        sim.n_total - (sim.n_finished_ok + sim.n_finished_late + sim.n_dropped
                       + sim.n_unserved + sim.n_rejected + sim.n_failed))
    return counted, wrong & {r.rid for r in counted}, lost


SHORT_GAP_NS = 50_000  # shorter idle gaps inside an executor call lie between a replay's kernels


def breakdown(tr, spans: list[tuple[int, int, int]]) -> dict:
    """The ten device operations that took most time, and the idle gaps by
    what the host was doing: inside the program's executor call, either
    between the kernels of a graph's replay (gaps under 50 us) or in its host
    part (padding, the copy of the tokens, the launch, the synchronizes);
    copying the checked logits; or in the event loop and the scheduler
    between batches."""
    ops = sorted(tr.seconds_by_name().items(), key=lambda kv: -kv[1])[:10]
    gaps = tr.idle_gaps()
    by = {"executor_host_pad_copy_launch_sync": 0.0, "between_kernels_of_a_replay": 0.0,
          "copying_checked_logits": 0.0, "event_loop_and_scheduler": 0.0}
    if spans:
        sp = np.asarray(spans, np.int64)
        for a, b in gaps:
            mid = (a + b) // 2
            i = int(np.searchsorted(sp[:, 0], mid, side="right")) - 1
            if i >= 0 and mid < sp[i, 1]:
                key = ("between_kernels_of_a_replay" if b - a < SHORT_GAP_NS
                       else "executor_host_pad_copy_launch_sync")
                by[key] += (b - a) / 1e9
            elif i >= 0 and mid < sp[i, 2]:
                by["copying_checked_logits"] += (b - a) / 1e9
            else:
                by["event_loop_and_scheduler"] += (b - a) / 1e9
    idle = sorted(by.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> tuple[dict, list[str]]:
    """One whole run → (the result's object, the lines that compare each
    number with its limit)."""
    from repro_torch.core.spans import SpanLog

    log = SpanLog() if trace else None
    engine, lm, w = setup(cell, seed, device, spans=log)
    setup_s = time.perf_counter() - t_start
    sim, requests, exe, tr = window(cell, engine, lm, seed, seconds, trace, device, spans=log)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    launches = {tuple(key): dict(program.launches)
                for key, (_, program) in getattr(engine.executor, "_shapes", {}).items()
                if hasattr(program, "launches")}

    slo = cell.traffic["slo_ms"]
    sample = exe.sample()
    batches, spans, raised, errors = exe.batches, exe.spans, exe.raised, exe.errors
    # Free the program and its weights before the reference runs (a
    # process's peak never falls), and make the weights again from the seed.
    del engine, exe, w
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = cell.checks["limits"]
    rows = compare(cell.config, sample, make_weights(cell.config, seed, device))
    worst, bad = judge(rows, limits)
    counted, failed, n_lost = tally(requests, sim, slo, raised | bad)

    run = Run(cell=cell, sim=sim, counted=counted, t_end_ms=sim.makespan_ms,
              slo_ms=slo, batches=batches, lm=lm, setup_s=setup_s, failed=failed, trace=tr,
              spans=log, launches=launches)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_metric(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    checks["requests_compared_at_least"] = {"value": len(rows), "limit": 1}
    checks["requests_raised"] = {"value": len(raised), "limit": 0}
    checks["requests_lost"] = {"value": n_lost, "limit": 0}
    correct = bool(rows) and not bad and not raised and n_lost == 0
    result = {
        "correct": correct,
        "attempted": len(counted),
        "failed": len(failed) + n_lost,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr, spans)
    result["checks"] = checks
    lines = [f"error: {e}" for e in errors[:5]]
    lines += [f"check {k}: {v['value']} limit {v['limit']}" for k, v in checks.items()]
    return result, lines
