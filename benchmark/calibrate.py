"""Readings that the limits of a cell's comparison are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--calls 1]

In one process on the card, for each of `--seeds`: the cell's images from
the seed, the traffic's own set-up and `--calls` of its calls (as many
again where a call answers fewer images than the deployment has: a
preview cell makes one request per image), driven, sampled and judged as a
run drives, samples and judges them (harness/main.py, harness/check.py):
the lower readings.  For each of `--control-seeds`: the reference computed
at TF32 put in the codec's place (for a decode cell, decoding the
containers the codec's set-up made) and judged the same way: the upper
readings.  One JSON
line per seed, then the largest program reading and the smallest control
reading of each number.  The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from benchmark.harness.registry import Registry  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s.strip()]


def readings(reg, workload, seeds, control_seeds, calls, device, program,
             emit=print):
    """-> (program readings, control readings), lists of number dicts."""
    import torch
    from benchmark.harness import check, images as synth
    from benchmark.harness.main import Sampler, drive
    from benchmark.harness.traffic import load

    wl = reg.workload(workload)
    config = reg.config(wl["config"])
    traffic = reg.traffic(wl["traffic"])
    img = config["images"]
    c = config["codec"]
    cfg = program.CodecConfig(c["color_space"], tuple(c["quality_range"]),
                              tuple(c["block_size_range"]),
                              c["entropy_level"])
    out = {"program": [], "control": []}
    for who, seed in [("program", s) for s in seeds] + \
            [("control", s) for s in control_seeds]:
        u8 = synth.synth(img["count"], img["height"], img["width"], seed,
                         device)
        images = synth.to_host_images(u8, img["extension"],
                                      program.ImageData)
        u8 = u8.cpu()
        mix = load(reg, cfg, program, traffic, images, device)
        sampler = Sampler(seed, img["count"], mix.per_call,
                          traffic["sample"])
        t0 = time.perf_counter()
        mix.setup()
        control = None
        if who == "program":
            drive(mix, sampler, n_calls=calls * max(
                1, img["count"] // mix.per_call))
            samples = {k: mix.judged(k, o) for k, o in sampler.kept.items()}
        else:
            control = "tf32"
            samples = {k: {} if mix.source(k) is None
                       else {"source": mix.source(k)}
                       for k in sampler.keys}
        run_s = time.perf_counter() - t0
        produces = mix.produces
        mix.release()
        tally, judge_s = check.timed_judge(produces, config, u8, samples,
                                           device, control=control)
        nums = tally.numbers()
        nums["failed"] = tally.failed
        out[who].append(nums)
        emit(json.dumps({"who": who, "seed": seed, "numbers": nums,
                         "stats": tally.stats(), "run_s": run_s,
                         "judge_s": judge_s}))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out["program"], out["control"]


def summary(program_readings, control_readings) -> dict:
    keys = sorted({k for r in program_readings + control_readings
                   for k in r if k != "failed"})
    return {k: {"lower": max((r[k] for r in program_readings if k in r),
                             default=None),
                "upper": min((r[k] for r in control_readings if k in r),
                             default=None)} for k in keys}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    import aejpeg_tpu_torch as program
    prog, ctl = readings(Registry(), args.workload, _seeds(args.seeds),
                         _seeds(args.control_seeds), args.calls,
                         torch.device("cuda:0"), program)
    print(json.dumps({"workload": args.workload,
                      "summary": summary(prog, ctl)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
