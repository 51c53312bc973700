"""Interactive codec explorer: the reference GUI's capabilities on the
port.

Counterpart of the JAX package's gui/app.py (the reference app,
src/gui/main_frame.py:33-222): a settings column (files, color space,
quality range, block-size range), a live preview with quality metrics and
compression ratio, and batch compress (image -> sibling .ajpg) /
decompress (.ajpg -> image) actions over the selected files.  Batch
compression groups same-shape images into `encode_batch` calls, and codec
work runs off the Tk event thread.

Every codec call runs on `device` (None: CUDA).  The jobs
(`_process_preview`, `_compress_job`, `_decompress_job`) and
`plan_batches` need no display; tkinter is imported when the window is
built.
"""

import functools
import os
import threading
from collections import defaultdict
from typing import Callable, List, Optional, Tuple

from ..codec.batch_encode import encode_batch
from ..codec.pipeline import Codec
from ..codec.stream import decode_stream
from ..color import get_color_spaces
from ..io.image import ImageData
from .control_panel import ControlPanel, PanelState
from .preview_panel import PreviewPanel, default_metrics_line


def plan_batches(paths: List[str]) -> List[List[Tuple[str, ImageData]]]:
    """Group image files by (H, W) so each group can ride one device batch.
    Pure helper, tested without a display."""
    groups = defaultdict(list)
    for p in paths:
        img = ImageData.load(p)
        groups[img.original_shape[:2]].append((p, img))
    return list(groups.values())


class AejpegApp:
    """Main application window."""

    def __init__(self, root, preview_path: Optional[str] = None,
                 state: Optional[PanelState] = None, device=None):
        from tkinter import ttk
        self.root = root
        root.title("aejpeg_tpu_torch — adaptive edge-aware codec")
        self.state = state or PanelState()
        self.device = device
        self.codec = Codec(self.state.to_config(), device=device)

        main = ttk.Frame(root, padding=10)
        main.pack(fill="both", expand=True)

        self.control_panel = ControlPanel(
            main, self.state, color_spaces=get_color_spaces(),
            on_settings_changed=self._settings_changed,
            on_compress=self.compress_selected,
            on_decompress=self.decompress_selected)
        self.control_panel.frame.pack(side="left", fill="y", padx=(0, 10))

        self.preview_panel = PreviewPanel(
            main, process_fn=self._process_preview,
            preview_path=preview_path,
            metrics_fn=functools.partial(default_metrics_line,
                                         device=device))
        self.preview_panel.frame.pack(side="right", fill="both", expand=True)

    # -- settings ----------------------------------------------------------
    def _settings_changed(self, state: PanelState) -> None:
        self.codec.update_settings(state.to_config())

    # -- preview -----------------------------------------------------------
    def _process_preview(self, img: ImageData) -> Tuple[ImageData, float]:
        blob = self.codec.compress(img)
        out = self.codec.decompress(blob)
        # ratio vs raw RGB bytes, as the reference reports it
        # (reference: src/gui/main_frame.py:148-151)
        return out, img.raw_rgb_bytes / len(blob)

    # -- batch actions -----------------------------------------------------
    def compress_selected(self) -> None:
        from tkinter import messagebox
        files = self.state.image_files()
        if not files:
            messagebox.showwarning("No image files selected",
                                   "Select image files to compress.")
            return
        self._run_job(self._compress_job, files, "Compression")

    def decompress_selected(self) -> None:
        from tkinter import messagebox
        files = self.state.ajpg_files()
        if not files:
            messagebox.showwarning("No .ajpg files selected",
                                   "Select .ajpg files to decompress.")
            return
        self._run_job(self._decompress_job, files, "Decompression")

    def _compress_job(self, files: List[str]) -> List[str]:
        """Encode each same-shape group with one encode_batch call, writing
        sibling .ajpg files; returns one error line per failed group."""
        errors = []
        cfg = self.state.to_config()
        for group in plan_batches(files):
            try:
                blobs = encode_batch([img for _, img in group], cfg,
                                     device=self.device)
                for (path, _), blob in zip(group, blobs):
                    with open(os.path.splitext(path)[0] + ".ajpg", "wb") as f:
                        f.write(blob)
            except Exception as e:  # isolate per group, keep going
                errors.append(f"{[p for p, _ in group]}: {e}")
        return errors

    def _decompress_job(self, files: List[str]) -> List[str]:
        """Batched decode through decode_stream; inside a failing batch,
        per-file decodes, so one bad container does not sink the others.
        Writes each image beside its .ajpg; returns the error lines."""
        errors = []
        blobs = []
        paths = []
        for path in files:
            try:
                with open(path, "rb") as f:
                    blobs.append(f.read())
                paths.append(path)
            except OSError as e:
                errors.append(f"{os.path.basename(path)}: {e}")
        if not blobs:
            return errors
        try:
            images = decode_stream(blobs, device=self.device)
        except Exception:   # retried one file at a time below
            images = []
            for path, blob in zip(paths, blobs):
                try:
                    images.append(Codec(device=self.device).decompress(blob))
                except Exception as e:
                    images.append(None)
                    errors.append(f"{os.path.basename(path)}: {e}")
        for path, img in zip(paths, images):
            if img is None:
                continue
            try:
                img.save(os.path.splitext(path)[0] + img.extension)
            except Exception as e:
                errors.append(f"{os.path.basename(path)}: {e}")
        return errors

    def _run_job(self, job: Callable[[List[str]], List[str]],
                 files: List[str], label: str) -> None:
        from tkinter import messagebox

        def work() -> None:
            errors = job(files)

            def report() -> None:
                if errors:
                    messagebox.showerror(
                        f"{label} finished with errors", "\n".join(errors))
                else:
                    messagebox.showinfo(f"{label} complete",
                                        f"{label} of {len(files)} file(s) "
                                        "finished.")
            self.root.after(0, report)

        threading.Thread(target=work, daemon=True).start()


def main(preview_path: Optional[str] = None, device=None) -> None:
    """Open the window (needs Tk and a display); codec work on `device`."""
    import tkinter as tk
    from .. import resolve_device
    dev = resolve_device(device)
    root = tk.Tk()
    AejpegApp(root, preview_path=preview_path, device=dev)
    root.mainloop()
