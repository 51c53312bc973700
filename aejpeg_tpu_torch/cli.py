"""Command-line interface of the PyTorch/CUDA port.

  aejpeg-torch compress   <in.png ...> -o outdir [--quality --blocks ...]
  aejpeg-torch decompress <in.ajpg ...> -o outdir
  aejpeg-torch preview    <in.png>      # compress+decompress+metrics report
  aejpeg-torch sweep      <imgdir> -o results.csv [...]
  aejpeg-torch compare    <results_dir>  # better-than-JPEG selection (anchors)
  aejpeg-torch analyze    <results_dir> --compression-file --quality-file [...]
  aejpeg-torch visualize  <in.png> -o outdir
  aejpeg-torch info       <in.ajpg>     # container metadata

(also `python -m aejpeg_tpu_torch.cli ...`).  The subcommands that run the
codec take --device: cuda by default, which fails without a CUDA device;
--device cpu runs the plain PyTorch path.  info, compare and analyze run on
the host only; compare and analyze need pandas.
"""

import argparse
import json
import os
import sys
from pathlib import Path


def _cfg_from_args(args):
    from .config import CodecConfig
    return CodecConfig(color_space=args.color_space,
                       quality_range=tuple(args.quality),
                       block_size_range=tuple(args.blocks),
                       entropy_level=args.entropy_level)


def _add_codec_args(p):
    p.add_argument("--color-space", default="YCoCg")
    p.add_argument("--quality", nargs=2, type=int, default=[40, 80],
                   metavar=("MIN", "MAX"))
    p.add_argument("--blocks", nargs=2, type=int, default=[4, 64],
                   metavar=("MIN", "MAX"))
    p.add_argument("--entropy-level", type=int, default=9)


def _add_device_arg(p):
    p.add_argument("--device", default=None,
                   help="cuda (default; fails without a CUDA device) or cpu")


def cmd_compress(args):
    from .codec.stream import encode_stream
    from .io.image import ImageData
    os.makedirs(args.output, exist_ok=True)
    images = [ImageData.load(p) for p in args.inputs]
    # continuous batching: same-shape images share device batches, host
    # entropy overlaps device compute of the next batch
    blobs = encode_stream(images, _cfg_from_args(args), device=args.device)
    for path, img, blob in zip(args.inputs, images, blobs):
        out = Path(args.output) / (Path(path).stem + ".ajpg")
        out.write_bytes(blob)
        ratio = img.raw_rgb_bytes / len(blob)
        print(f"{path} -> {out} ({len(blob)} bytes, {ratio:.2f}x)")


def cmd_decompress(args):
    from .codec.stream import decode_stream
    os.makedirs(args.output, exist_ok=True)
    blobs = [Path(p).read_bytes() for p in args.inputs]
    for path, img in zip(args.inputs,
                         decode_stream(blobs, device=args.device)):
        ext = (img.extension or ".png").lstrip(".")
        out = Path(args.output) / (Path(path).stem + f"_decompressed.{ext}")
        img.save(str(out))
        print(f"{path} -> {out}")


def cmd_preview(args):
    from .codec.pipeline import Codec
    from .io.image import ImageData
    from .metrics import EvaluationMetrics
    img = ImageData.load(args.input)
    codec = Codec(_cfg_from_args(args), device=args.device)
    blob = codec.compress(img)
    out = Codec(device=args.device).decompress(blob)
    ev = EvaluationMetrics(img, out, device=args.device)
    report = {
        "input": args.input,
        "config": {"color_space": args.color_space,
                   "quality": args.quality, "blocks": args.blocks},
        "compressed_bytes": len(blob),
        "compression_ratio": round(img.raw_rgb_bytes / len(blob), 4),
        "psnr": round(ev.psnr(), 4),
        "ssim": round(ev.ssim(), 4),
        "ms_ssim": round(ev.ms_ssim(), 4),
    }
    try:
        report["lpips"] = round(ev.lpips(), 4)
    except FileNotFoundError:
        report["lpips"] = None
    if args.save:
        out.save(args.save)
        report["saved"] = args.save
    print(json.dumps(report, indent=2))


def cmd_sweep(args):
    exts = {".png", ".tiff", ".bmp"}
    files = sorted(p for p in Path(args.imgdir).rglob("*")
                   if p.is_file() and p.suffix in exts)
    if args.limit:
        files = files[:args.limit]
    qv = tuple(args.quality_values)
    bv = tuple(args.block_values)
    quality_ranges = [(a, b) for a in qv for b in qv if a <= b]
    block_ranges = [(a, b) for a in bv for b in bv if a <= b]
    if args.per_image:
        # per-image path (one Codec per combo): slow, kept for
        # cross-checking the batched engine
        from .harness.sweep import MetricsSweep
        sweep = MetricsSweep(
            files, args.output,
            color_spaces=args.color_spaces,
            quality_ranges=quality_ranges,
            block_size_ranges=block_ranges,
            with_lpips=args.lpips, lpips_weights=args.lpips_weights,
            entropy_level=args.entropy_level, device=args.device)
    else:
        from .harness.sweep_batched import BatchedMetricsSweep
        sweep = BatchedMetricsSweep(
            files, args.output,
            color_spaces=args.color_spaces,
            quality_ranges=quality_ranges,
            block_size_ranges=block_ranges,
            entropy_level=args.entropy_level,
            with_lpips=args.lpips, lpips_weights=args.lpips_weights,
            device=args.device)
    sweep.run()


def cmd_compare(args):
    from .harness.compare import MetricsComparison
    cmp_ = MetricsComparison(
        input_dir=args.results_dir,
        file_list=args.files or None,
        quality_threshold=args.quality_threshold,
        compression_threshold=args.compression_threshold)
    outputs = cmp_.run()
    print(json.dumps({
        "better_compression": len(cmp_.better_compression),
        "better_quality": len(cmp_.better_quality),
        "outputs": {k: str(v) for k, v in outputs.items()},
    }, indent=2))


def cmd_analyze(args):
    from .harness.analyze import MetricsAnalysis
    an = MetricsAnalysis(args.results_dir, args.figures_dir,
                         args.compression_file, args.quality_file)
    sub = an.subsampling_analysis(visualize=args.plots)
    top = an.settings_analysis(top_n=args.top, visualize=args.plots)
    print(sub.to_string(index=False))
    for name, df in top.items():
        print(f"--- {name}")
        print(df.to_string(index=False))


def cmd_visualize(args):
    from .harness.visualize import visualize
    visualize(args.input, args.output, _cfg_from_args(args),
              device=args.device)


def cmd_info(args):
    from .io.container import ContainerReader
    for path in args.inputs:
        r = ContainerReader(Path(path).read_bytes())
        m = r.metadata
        layers = r.read_layers()
        print(json.dumps({
            "file": path, "height": m.height, "width": m.width,
            "color_space": m.color_space,
            "quality": [m.quality_min, m.quality_max],
            "blocks": [m.block_size_min, m.block_size_max],
            "extension": m.extension,
            "layer_root_sizes": [layer.root_size for layer in layers],
            "layer_coeff_counts": [int(layer.coeffs.size)
                                   for layer in layers],
        }, indent=2))


def main(argv=None):
    p = argparse.ArgumentParser(prog="aejpeg-torch",
                                description="Adaptive edge-aware JPEG "
                                            "codec on PyTorch + CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress")
    c.add_argument("inputs", nargs="+")
    c.add_argument("-o", "--output", default=".")
    _add_codec_args(c)
    _add_device_arg(c)
    c.set_defaults(fn=cmd_compress)

    d = sub.add_parser("decompress")
    d.add_argument("inputs", nargs="+")
    d.add_argument("-o", "--output", default=".")
    _add_device_arg(d)
    d.set_defaults(fn=cmd_decompress)

    v = sub.add_parser("preview")
    v.add_argument("input")
    v.add_argument("--save")
    _add_codec_args(v)
    _add_device_arg(v)
    v.set_defaults(fn=cmd_preview)

    s = sub.add_parser("sweep")
    s.add_argument("imgdir")
    s.add_argument("-o", "--output", required=True)
    s.add_argument("--color-spaces", nargs="+", default=["YCbCr"])
    s.add_argument("--quality-values", nargs="+", type=int,
                   default=[10, 25, 50, 75, 90])
    s.add_argument("--block-values", nargs="+", type=int,
                   default=[4, 8, 16, 32, 64, 128])
    s.add_argument("--lpips", action="store_true")
    s.add_argument("--lpips-weights", default=None,
                   help=".npz from metrics.lpips.convert_torch_checkpoint")
    s.add_argument("--per-image", action="store_true",
                   help="per-image Codec path (slow; cross-check)")
    s.add_argument("--limit", type=int, default=0)
    s.add_argument("--entropy-level", type=int, default=-1)
    _add_device_arg(s)
    s.set_defaults(fn=cmd_sweep)

    cp = sub.add_parser("compare", help="flag configs beating the standard-"
                        "JPEG anchors (reference metrics_comparison.py)")
    cp.add_argument("results_dir")
    cp.add_argument("--files", nargs="*", default=None)
    cp.add_argument("--quality-threshold", type=float, default=0.05)
    cp.add_argument("--compression-threshold", type=float, default=0.05)
    cp.set_defaults(fn=cmd_compare)

    an = sub.add_parser("analyze", help="subsampling/settings stats + "
                        "heatmaps (reference metrics_analysis.py)")
    an.add_argument("results_dir")
    an.add_argument("--figures-dir", default="figures")
    an.add_argument("--compression-file", required=True)
    an.add_argument("--quality-file", required=True)
    an.add_argument("--top", type=int, default=5)
    an.add_argument("--plots", action="store_true")
    an.set_defaults(fn=cmd_analyze)

    w = sub.add_parser("visualize")
    w.add_argument("input")
    w.add_argument("-o", "--output", default="quadtree_vis")
    _add_codec_args(w)
    _add_device_arg(w)
    w.set_defaults(fn=cmd_visualize)

    i = sub.add_parser("info")
    i.add_argument("inputs", nargs="+")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    if hasattr(args, "device"):
        from . import resolve_device
        try:
            args.device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            p.error(str(e))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
