"""Control panel: file selection, color space, quality / block-size ranges.

Counterpart of the JAX package's gui/control_panel.py (the reference's
control panel, src/gui/control_panel.py:28-281): batch file picker,
read-only color-space combobox over the public registry, a quality
RangeSlider and a block-size-exponent RangeSlider (shown and exported as
2**k), and Compress / Decompress buttons.

The settings model is the plain :class:`PanelState` dataclass, whose
``to_config()`` keeps the settings semantics (exponent -> block size,
range ordering) testable without a display; tkinter is imported when a
panel is built.
"""

import os
from dataclasses import dataclass, field
from typing import Callable, List, Sequence, Tuple

from ..config import CodecConfig
from .range_slider import RangeSlider


@dataclass
class PanelState:
    """Headless settings model behind the widgets."""
    color_space: str = "YCoCg"
    quality: Tuple[int, int] = (20, 60)
    block_exponents: Tuple[int, int] = (2, 6)
    files: List[str] = field(default_factory=list)

    @property
    def block_sizes(self) -> Tuple[int, int]:
        return (2 ** self.block_exponents[0], 2 ** self.block_exponents[1])

    def to_config(self) -> CodecConfig:
        return CodecConfig(self.color_space, self.quality, self.block_sizes)

    def image_files(self) -> List[str]:
        return [f for f in self.files if not f.lower().endswith(".ajpg")]

    def ajpg_files(self) -> List[str]:
        return [f for f in self.files if f.lower().endswith(".ajpg")]


class ControlPanel:
    """Left-hand settings column of the app window."""

    def __init__(self, parent, state: PanelState,
                 color_spaces: Sequence[str],
                 on_settings_changed: Callable[[PanelState], None],
                 on_compress: Callable[[], None],
                 on_decompress: Callable[[], None],
                 quality_bounds: Tuple[int, int] = (1, 99),
                 exponent_bounds: Tuple[int, int] = (1, 8),
                 filetypes: Sequence[Tuple[str, str]] = (
                     ("Image files", "*.png *.jpg *.jpeg *.bmp *.tiff"),
                     ("AJPG files", "*.ajpg"),
                 )):
        import tkinter as tk
        from tkinter import ttk
        self.state = state
        self._notify = on_settings_changed
        self._filetypes = tuple(filetypes)

        self.frame = ttk.Frame(parent)

        # batch files ------------------------------------------------------
        files_box = ttk.LabelFrame(self.frame, text="Batch Processing",
                                   padding=8)
        files_box.pack(fill="x", pady=(0, 8))
        ttk.Button(files_box, text="Select Files…",
                   command=self._pick_files).pack(fill="x")
        self.files_list = tk.Listbox(files_box, height=4, width=34)
        self.files_list.pack(fill="x", pady=(4, 0))
        self._refresh_files()

        # color space ------------------------------------------------------
        color_box = ttk.LabelFrame(self.frame, text="Color Space", padding=8)
        color_box.pack(fill="x", pady=(0, 8))
        self.color_var = tk.StringVar(value=state.color_space)
        combo = ttk.Combobox(color_box, textvariable=self.color_var,
                             values=list(color_spaces), state="readonly")
        combo.pack(fill="x")
        combo.bind("<<ComboboxSelected>>", self._color_changed)

        # quality ----------------------------------------------------------
        q_box = ttk.LabelFrame(self.frame, text="Quality Range", padding=8)
        q_box.pack(fill="x", pady=(0, 8))
        self.quality_label = ttk.Label(q_box)
        self.quality_label.pack(anchor="w")
        self.quality_slider = RangeSlider(
            q_box, on_drag=self._quality_dragged, on_commit=self._committed,
            lo=quality_bounds[0], hi=quality_bounds[1],
            init_lo=state.quality[0], init_hi=state.quality[1])
        self.quality_slider.pack(fill="x")
        self._quality_dragged(state.quality)

        # block size -------------------------------------------------------
        b_box = ttk.LabelFrame(self.frame, text="Block Size Range", padding=8)
        b_box.pack(fill="x", pady=(0, 8))
        self.block_label = ttk.Label(b_box)
        self.block_label.pack(anchor="w")
        self.block_slider = RangeSlider(
            b_box, on_drag=self._block_dragged, on_commit=self._committed,
            lo=exponent_bounds[0], hi=exponent_bounds[1],
            init_lo=state.block_exponents[0],
            init_hi=state.block_exponents[1])
        self.block_slider.pack(fill="x")
        self._block_dragged(state.block_exponents)

        # actions ----------------------------------------------------------
        actions = ttk.Frame(self.frame)
        actions.pack(fill="x", pady=(4, 0))
        ttk.Button(actions, text="Compress",
                   command=on_compress).pack(side="left", expand=True,
                                             fill="x", padx=(0, 4))
        ttk.Button(actions, text="Decompress",
                   command=on_decompress).pack(side="right", expand=True,
                                               fill="x", padx=(4, 0))
        ttk.Label(self.frame, text="Compressed files are written as .ajpg",
                  font=("", 8)).pack(anchor="w", pady=(6, 0))

    # -- callbacks ---------------------------------------------------------
    def _pick_files(self) -> None:
        from tkinter import filedialog
        picked = filedialog.askopenfilenames(filetypes=self._filetypes)
        if picked:
            self.state.files = list(picked)
            self._refresh_files()
            self._committed()

    def _refresh_files(self) -> None:
        self.files_list.delete(0, "end")
        if self.state.files:
            for f in self.state.files:
                self.files_list.insert("end", os.path.basename(f))
        else:
            self.files_list.insert("end", "(no files selected)")

    def _color_changed(self, _event=None) -> None:
        self.state.color_space = self.color_var.get()
        self._committed()

    def _quality_dragged(self, values: Tuple[int, int]) -> None:
        self.state.quality = values
        self.quality_label.config(
            text=f"Quality: {values[0]} – {values[1]}")

    def _block_dragged(self, values: Tuple[int, int]) -> None:
        self.state.block_exponents = values
        lo, hi = self.state.block_sizes
        self.block_label.config(text=f"Block size: {lo} – {hi}")

    def _committed(self) -> None:
        self._notify(self.state)
