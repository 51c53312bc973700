"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (import, kernel builds on a checkout's first run, the seeded
images, the traffic's own set-up and a warm-up with its own calls) runs
from process start to the first timed call: that is `setup_s`.  Then the
traffic's calls run back to back for `--seconds`; the last call started
runs to its end.  With `--trace 1` the program's structured log is on
(its stage events add a synchronise a batch), and after the window a few
more calls run under torch.profiler.  Once the window has closed, the
peak device memory is read, the program's state freed, and a sample of
the window's outputs, drawn from the seed, is judged against the plain
reference (harness/check.py).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, [breakdown], and `checks`, each number compared
beside its limit; the same numbers are the last lines of standard error.
"""

import argparse
import gc
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

from .registry import ROOT, Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "aejpeg_tpu")
PROGRAM = "aejpeg_tpu_torch"
PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name, power limit and SM clock, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def build_state() -> Dict[str, float]:
    """The program's build outputs in the checkout: path -> mtime."""
    out = {}
    build = os.path.join(ROOT, PROGRAM, "build")
    if os.path.isdir(build):
        for f in os.listdir(build):
            out[os.path.join(build, f)] = os.path.getmtime(
                os.path.join(build, f))
    so = os.path.join(ROOT, PROGRAM, "native", "libaejentropy.so")
    if os.path.exists(so):
        out[so] = os.path.getmtime(so)
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Sampler:
    """A seeded sample of the window's outputs: `size` distinct images, and
    for each one output drawn uniformly from all the window's outputs of
    that image (reservoir sampling, so memory stays one output an image)."""

    def __init__(self, seed: int, n_images: int, per_call: int, size: int):
        self.per_call = per_call
        self.rng = random.Random(seed * 7919 + 17)
        self.keys = set(self.rng.sample(range(n_images),
                                        min(size, n_images)))
        reps = max(1, per_call // n_images)
        self.pos = {k: k + n_images * self.rng.randrange(reps)
                    for k in self.keys}
        self.seen: Dict[int, int] = {}
        self.kept: Dict[int, object] = {}

    def offer(self, key: int, position: int, output) -> None:
        """Output `position` of a call (-1: a request's only output)
        answers image `key`."""
        if key not in self.keys or (position != self.pos[key]
                                    and position >= 0):
            return
        self.seen[key] = self.seen.get(key, 0) + 1
        if self.rng.randrange(self.seen[key]) == 0:
            self.kept[key] = _copy_output(output)


def _copy_output(out):
    """Sampled outputs keep no view of the program's host buffers."""
    import numpy as np
    if isinstance(out, tuple):
        return tuple(_copy_output(o) for o in out)
    data = getattr(out, "data", None)
    if isinstance(data, np.ndarray):
        return np.array(data, copy=True)
    return out


def _missing(out) -> bool:
    if isinstance(out, tuple):
        return any(_missing(o) for o in out[1:])
    return out is None or (isinstance(out, (bytes, bytearray))
                           and not out)


def drive(mix, sampler: Sampler, end: Optional[float] = None,
          n_calls: Optional[int] = None, on_call=None):
    """The mix's calls back to back, until one ends after `end` (host
    perf_counter) or `n_calls` have run; every output is offered to the
    sampler.  -> (calls' (start, end), spans, outputs, missing outputs)"""
    calls, spans, attempted, missing = [], [], 0, 0
    while True:
        a = time.perf_counter()
        outs, sp = mix.call()
        b = time.perf_counter()
        calls.append((a, b))
        if on_call is not None:
            on_call(b)
        spans.extend(sp)
        for i, out in enumerate(outs):
            attempted += 1
            missing += _missing(out)
            sampler.offer(mix.output_image(out, i), mix.position(i), out)
        if (end is not None and b >= end) or len(calls) == n_calls:
            return calls, spans, attempted, missing


def run_cell(reg: Registry, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device=None, program=None,
             look_for_chip: bool = True) -> int:
    """Run the cell; print the result line.  Returns the exit code."""
    wl = reg.workload(workload)
    config = reg.config(wl["config"])
    traffic = reg.traffic(wl["traffic"])
    limits = reg.limits(workload)
    wanted = reg.metrics_of(workload, trace)
    events_path = os.path.join(tempfile.gettempdir(),
                               "aejpeg_bench_events.jsonl")
    if trace:
        if os.path.exists(events_path):
            os.remove(events_path)
        os.environ["AEJPEG_LOG"] = events_path
    else:
        os.environ.pop("AEJPEG_LOG", None)

    import torch
    if look_for_chip:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < wl["chips"]:
            log(f"{workload} needs {wl['chips']} CUDA device(s); "
                f"available: {torch.cuda.device_count()}")
            return 2
        device = torch.device("cuda:0")
        log(f"card: {card_line()}")
    built_before = build_state()
    if program is None:
        import aejpeg_tpu_torch as program
    from . import check, host, images as synth
    from .trace import read_events, stage_intervals
    from .traffic import load

    img = config["images"]
    c = config["codec"]
    cfg = program.CodecConfig(c["color_space"], tuple(c["quality_range"]),
                              tuple(c["block_size_range"]),
                              c["entropy_level"])
    u8 = synth.synth(img["count"], img["height"], img["width"], seed,
                     device)
    host_images = synth.to_host_images(u8, img["extension"],
                                       program.ImageData)
    u8 = u8.cpu()
    mix = load(reg, cfg, program, traffic, host_images, device)
    mix.setup()
    warm_end = time.perf_counter() + traffic["warm_seconds"]
    for k in range(10 ** 6):
        if k >= traffic["warm_calls"] and time.perf_counter() >= warm_end:
            break
        mix.call()
    built = build_state() != built_before
    t0 = time.perf_counter()
    wall0 = time.time()
    setup_s = t0 - t_start
    log(f"set-up {setup_s:.3f} s; built anything: {built}")

    sampler = Sampler(seed, img["count"], mix.per_call, traffic["sample"])
    window = host.Window()
    window.mark(t0)
    calls, spans, attempted, missing = drive(mix, sampler, end=t0 + seconds,
                                             on_call=window.mark)
    wall1 = time.time()
    log(f"host: {window.summary(calls)}")
    log(f"host by tenths of the window: {window.tenths()}")
    if look_for_chip:
        log(f"card after the window: {card_line()}")
    log(f"window {calls[-1][1] - calls[0][0]:.3f} s, {len(calls)} calls, "
        f"{attempted} outputs")

    dtrace = None
    events = []
    work = None
    if trace:
        dtrace, work = _profile(mix, calls, traffic, device, config)
        events = read_events(events_path)
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device is not None and torch.device(device).type == "cuda"
                else 0)
    samples = {k: mix.judged(k, out) for k, out in sampler.kept.items()}
    produces = mix.produces
    mix.release()
    del mix
    gc.collect()
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {bad}")
        return 3

    tally, judge_s = check.timed_judge(produces, config, u8, samples,
                                       device)
    numbers = tally.numbers()
    failed = missing + tally.failed
    correct = check.verdict(numbers, limits, failed)
    stats = tally.stats()
    log(f"sample: {stats}")
    log(f"comparison {judge_s:.3f} s")

    mpix = img["height"] * img["width"] / 1e6
    per_call = sampler.per_call
    ctx = SimpleNamespace(
        workload=workload, config=config, traffic=traffic, setup_s=setup_s,
        calls=calls, mpix_per_call=mpix * per_call,
        spans=spans,
        events=[e for e in events if wall0 <= e.get("ts", 0) <= wall1],
        trace=dtrace, work=work, peaks=_peaks(device, torch), log=log)
    metrics = {}
    for m in wanted:
        ctx.metric = m["name"]
        value = reg.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": (torch.cuda.get_device_name(0)
                                       if look_for_chip else str(device)),
           "count": wl["chips"], "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s
        dev["window_s"] = dtrace.window_s
        stages = stage_intervals(events, {"encode_batch": "encode",
                                          "decode_batch": "decode"})
        stages += work["spans"]
        result["breakdown"] = {"device_ops": dtrace.top_ops(10),
                               "idle_gaps": dtrace.idle_gaps(stages, 10)}
    result["checks"] = {k: {"value": numbers.get(k), "limit": v}
                        for k, v in limits.items()}
    result["checks"]["failed_outputs"] = {"value": failed, "limit": 0}
    if trace and os.path.exists(events_path):
        os.remove(events_path)
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


def _peaks(device, torch) -> Optional[dict]:
    with open(PEAKS) as f:
        table = json.load(f)
    if device is None or torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(0)
    for key, peaks in table.items():
        if name.startswith(key):
            return peaks
    return None


def _profile(mix, calls, traffic, device, config):
    """torch.profiler over a few whole calls after the window; returns the
    device trace and the work those calls needed (their containers'
    leaves, for the kernels' rooflines)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from .trace import MARK_END, MARK_START, from_chrome
    per_call = statistics.median(b - a for a, b in calls)
    k = max(1, round(traffic["profile_seconds"] / max(per_call, 1e-6)))
    acts = [ProfilerActivity.CPU]
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    outs, spans = None, []
    with profile(activities=acts) as prof:
        with record_function(MARK_START):
            host_mark = time.time()
        for _ in range(k):
            outs, sp = mix.call()
            spans.extend(sp)
        if cuda:
            torch.cuda.synchronize()
        with record_function(MARK_END):
            pass
    path = os.path.join(tempfile.gettempdir(), "aejpeg_bench_trace.json")
    prof.export_chrome_trace(path)
    dtrace = from_chrome(path, host_mark)
    os.remove(path)
    del prof
    blobs = mix.containers(outs)
    work = {"calls": k, "spans": spans, "repeat": mix.p.get("repeat", 1),
            "leaves": None if blobs is None else _leaf_counts(blobs, config)}
    return dtrace, work


def _leaf_counts(blobs, config):
    """{layer: {size: leaves}} summed over the containers."""
    from .check import parsed_leaves
    out: Dict[int, Dict[int, int]] = {}
    for blob in blobs:
        layers = parsed_leaves(blob, config)
        if layers is None:
            continue
        for li, lay in enumerate(layers):
            for s, (ys, _, _) in lay.items():
                d = out.setdefault(li, {})
                d[s] = d.get(s, 0) + len(ys)
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    return run_cell(Registry(), args.workload, args.seed, args.seconds,
                    bool(args.trace), t_start)
