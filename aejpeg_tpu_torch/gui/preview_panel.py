"""Preview panel: original above, round-tripped image below, metrics line.

Counterpart of the JAX package's gui/preview_panel.py (the reference's
preview panel, src/gui/preview_panel.py:30-279): select a preview image,
run compress -> decompress with the live settings, show both images
stacked on a canvas with a PSNR / SSIM / MS-SSIM / LPIPS /
compression-ratio report.  Processing runs on a worker thread and posts
its results back with ``after()``, so the codec never blocks the event
loop.

The images reach Tk as binary PPM built with numpy, shrunk to their box
by the port's own INTER_AREA resize (`thumbnail`), so the panel needs
neither PIL nor imageio; tkinter is imported when a panel is built.
"""

import threading
import traceback
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.image import ImageData
from ..ops.resize import resize2d

# process_fn: ImageData -> (round-tripped ImageData, compression ratio)
ProcessFn = Callable[[ImageData], Tuple[ImageData, float]]
# metrics_fn: (original, processed) -> formatted metrics string
MetricsFn = Callable[[ImageData, ImageData], str]


def default_metrics_line(original: ImageData, processed: ImageData,
                         device=None) -> str:
    """PSNR/SSIM/MS-SSIM/LPIPS through EvaluationMetrics on `device` (None:
    CUDA); LPIPS reads "n/a" when no weights are available."""
    from ..metrics import EvaluationMetrics
    ev = EvaluationMetrics(original.data, processed.data, device=device)
    try:
        lp = f"{ev.lpips():.4f}"
    except FileNotFoundError:
        lp = "n/a"
    return (f"PSNR: {ev.psnr():.4f}    SSIM: {ev.ssim():.4f}    "
            f"MS-SSIM: {ev.ms_ssim():.4f}    LPIPS: {lp}")


def thumbnail(rgb_u8: np.ndarray, box: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 shrunk (never enlarged) to fit a (width, height)
    box, aspect kept, by INTER_AREA on the CPU."""
    h, w = rgb_u8.shape[:2]
    scale = min(box[0] / w, box[1] / h)
    if scale >= 1.0:
        return rgb_u8
    dh, dw = max(1, round(h * scale)), max(1, round(w * scale))
    planes = torch.from_numpy(rgb_u8).permute(2, 0, 1).to(torch.float32)
    small = resize2d(planes, (dh, dw), "area")
    return (torch.clamp(torch.round(small), 0, 255).to(torch.uint8)
            .permute(1, 2, 0).contiguous().numpy())


def ppm_bytes(rgb_u8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> a binary PPM (P6) file's bytes."""
    h, w = rgb_u8.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
        rgb_u8, np.uint8).tobytes()


class PreviewPanel:
    """Right-hand preview column of the app window."""

    def __init__(self, parent, process_fn: ProcessFn,
                 preview_path: Optional[str] = None,
                 metrics_fn: MetricsFn = default_metrics_line,
                 filetypes: Sequence[Tuple[str, str]] = (
                     ("Image files", "*.png *.jpg *.jpeg *.bmp *.tiff"),
                 ),
                 canvas_size: Tuple[int, int] = (520, 620)):
        import tkinter as tk
        from tkinter import ttk
        self.parent = parent
        self.process_fn = process_fn
        self.metrics_fn = metrics_fn
        self.preview_path = preview_path
        self._filetypes = tuple(filetypes)
        self._photos = [None, None]  # keep PhotoImage refs alive
        self._busy = False

        self.frame = ttk.LabelFrame(parent, text="Preview", padding=8)
        bar = ttk.Frame(self.frame)
        bar.pack(fill="x", pady=(0, 6))
        ttk.Button(bar, text="Select Preview Image",
                   command=self._browse).pack(side="left")
        self.update_btn = ttk.Button(bar, text="Update Preview",
                                     command=self.process_and_display)
        self.update_btn.pack(side="right")

        self.canvas = tk.Canvas(self.frame, bg="#f2f2f2",
                                width=canvas_size[0], height=canvas_size[1])
        self.canvas.pack(fill="both", expand=True)
        self.status = ttk.Label(self.frame, text="")
        self.status.pack(anchor="w", pady=(6, 0))

        if preview_path:
            self.parent.after(100, self.process_and_display)

    # -- actions -----------------------------------------------------------
    def _browse(self) -> None:
        from tkinter import filedialog
        path = filedialog.askopenfilename(filetypes=self._filetypes)
        if path:
            self.preview_path = path
            self.process_and_display()

    def process_and_display(self) -> None:
        if not self.preview_path or self._busy:
            return
        self._busy = True
        self.update_btn.state(["disabled"])
        self.status.config(text="Processing…")
        path = self.preview_path

        def work() -> None:
            try:
                original = ImageData.load(path)
                processed, ratio = self.process_fn(original)
                line = self.metrics_fn(original, processed)
                text = f"{line}\nCompression ratio: {ratio:.2f}x"
                self.parent.after(
                    0, lambda: self._show(original, processed, text))
            except Exception:   # reported in the panel; the UI keeps running
                err = traceback.format_exc(limit=3)
                self.parent.after(0, lambda: self._fail(err))

        threading.Thread(target=work, daemon=True).start()

    # -- rendering ---------------------------------------------------------
    def _fit(self, arr: np.ndarray, box: Tuple[int, int]):
        import tkinter as tk
        return tk.PhotoImage(data=ppm_bytes(thumbnail(arr, box)),
                             format="PPM")

    def _show(self, original: ImageData, processed: ImageData,
              text: str) -> None:
        self._busy = False
        self.update_btn.state(["!disabled"])
        self.status.config(text=text)
        w = max(self.canvas.winfo_width(), 64)
        h = max(self.canvas.winfo_height(), 64)
        half = (w - 8, h // 2 - 12)
        self._photos[0] = self._fit(original.get_uint8(), half)
        self._photos[1] = self._fit(processed.get_uint8(), half)
        self.canvas.delete("all")
        self.canvas.create_image(w // 2, h // 4, image=self._photos[0])
        self.canvas.create_line(4, h // 2, w - 4, h // 2, fill="#999999")
        self.canvas.create_image(w // 2, 3 * h // 4, image=self._photos[1])
        self.canvas.create_text(8, 8, anchor="nw", text="original",
                                fill="#555555")
        self.canvas.create_text(8, h // 2 + 8, anchor="nw",
                                text="round-trip", fill="#555555")

    def _fail(self, err: str) -> None:
        self._busy = False
        self.update_btn.state(["!disabled"])
        self.status.config(text=f"Preview failed:\n{err}")
