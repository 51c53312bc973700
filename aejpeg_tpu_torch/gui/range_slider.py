"""Dual-handle range slider widget.

Counterpart of the JAX package's gui/range_slider.py (the reference's
custom Tk canvas slider, src/gui/range_slider.py:24-343): two draggable
handles select an integer (min, max) range; values snap to integers; a live
callback fires while dragging and a commit callback on release.

The value<->pixel mapping and drag resolution live in the pure
:class:`RangeModel`, testable without a display.  :class:`RangeSlider`
holds a Tk canvas (tkinter is imported when one is built).
"""

from typing import Callable, Optional, Tuple


class RangeModel:
    """Pure state for a two-handle range over [lo, hi] integers."""

    def __init__(self, lo: int, hi: int, init_lo: int, init_hi: int,
                 track_px: int):
        if hi <= lo:
            raise ValueError("range must satisfy hi > lo")
        self.lo = lo
        self.hi = hi
        self.track_px = track_px
        self.low = min(max(init_lo, lo), hi)
        self.high = min(max(init_hi, lo), hi)
        if self.low > self.high:
            self.low, self.high = self.high, self.low
        self.active: Optional[str] = None  # "low" | "high" while dragging

    # -- mapping -----------------------------------------------------------
    def value_to_px(self, value: float) -> float:
        return (value - self.lo) / (self.hi - self.lo) * self.track_px

    def px_to_value(self, px: float) -> int:
        frac = min(max(px / self.track_px, 0.0), 1.0)
        return round(self.lo + frac * (self.hi - self.lo))

    # -- interaction -------------------------------------------------------
    def grab(self, px: float) -> str:
        """Pick the handle nearest to a press at `px` (ties -> the handle
        that can still move toward the press)."""
        d_low = abs(px - self.value_to_px(self.low))
        d_high = abs(px - self.value_to_px(self.high))
        if d_low < d_high:
            self.active = "low"
        elif d_high < d_low:
            self.active = "high"
        else:  # coincident handles: move in the direction of the press
            self.active = "low" if self.px_to_value(px) < self.low else "high"
        return self.active

    def drag(self, px: float) -> bool:
        """Move the grabbed handle; handles may not cross. Returns True if
        a value changed."""
        if self.active is None:
            return False
        v = self.px_to_value(px)
        if self.active == "low":
            v = min(v, self.high)
            changed = v != self.low
            self.low = v
        else:
            v = max(v, self.low)
            changed = v != self.high
            self.high = v
        return changed

    def release(self) -> None:
        self.active = None

    @property
    def values(self) -> Tuple[int, int]:
        return (self.low, self.high)


class RangeSlider:
    """A Tk canvas rendering a :class:`RangeModel` (`canvas` is the
    widget; `pack` places it)."""

    def __init__(self, parent, on_drag: Callable[[Tuple[int, int]], None],
                 on_commit: Callable[[], None], lo: int, hi: int,
                 init_lo: int, init_hi: int, width: int = 280,
                 height: int = 40, handle_radius: int = 9,
                 track_width: int = 6, track_color: str = "#c4c4c4",
                 range_color: str = "#3d7dd8", handle_color: str = "#1d4e89",
                 **kwargs):
        import tkinter as tk
        self.canvas = tk.Canvas(parent, width=width, height=height,
                                highlightthickness=0, **kwargs)
        self._pad = handle_radius + 2
        self.model = RangeModel(lo, hi, init_lo, init_hi,
                                track_px=width - 2 * self._pad)
        self._on_drag = on_drag
        self._on_commit = on_commit
        self._height = height
        self._radius = handle_radius
        self._track_width = track_width
        self._colors = (track_color, range_color, handle_color)
        self._redraw()
        self.canvas.bind("<Button-1>", self._press)
        self.canvas.bind("<B1-Motion>", self._motion)
        self.canvas.bind("<ButtonRelease-1>", self._release)

    def pack(self, **kwargs) -> None:
        self.canvas.pack(**kwargs)

    # -- event plumbing ----------------------------------------------------
    def _press(self, event) -> None:
        self.model.grab(event.x - self._pad)
        if self.model.drag(event.x - self._pad):
            self._changed()

    def _motion(self, event) -> None:
        if self.model.drag(event.x - self._pad):
            self._changed()

    def _release(self, _event) -> None:
        self.model.release()
        self._on_commit()

    def _changed(self) -> None:
        self._redraw()
        self._on_drag(self.model.values)

    # -- rendering ---------------------------------------------------------
    def _redraw(self) -> None:
        c = self.canvas
        c.delete("all")
        y = self._height // 2
        track, rng, handle = self._colors
        x0, x1 = self._pad, self._pad + self.model.track_px
        lx = self._pad + self.model.value_to_px(self.model.low)
        hx = self._pad + self.model.value_to_px(self.model.high)
        c.create_line(x0, y, x1, y, width=self._track_width, fill=track,
                      capstyle="round")
        c.create_line(lx, y, hx, y, width=self._track_width, fill=rng,
                      capstyle="round")
        r = self._radius
        for x in (lx, hx):
            c.create_oval(x - r, y - r, x + r, y + r, fill=handle,
                          outline="")

    # -- public API --------------------------------------------------------
    def get_values(self) -> Tuple[int, int]:
        return self.model.values

    def set_values(self, low: int, high: int) -> None:
        self.model.low = min(max(low, self.model.lo), self.model.hi)
        self.model.high = min(max(high, self.model.lo), self.model.hi)
        self._redraw()
        self._on_drag(self.model.values)
