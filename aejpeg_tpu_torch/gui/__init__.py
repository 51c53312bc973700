"""Tkinter GUI: interactive codec explorer.

Counterpart of the JAX package's gui/ (the reference GUI surface,
src/gui/__init__.py:20-24: JpegApp / ControlPanel / PreviewPanel /
RangeSlider) on the port.  Importing it needs no Tk and no display: the
settings model, the batch planner and the jobs run headless; building a
window needs both.
"""

from .app import AejpegApp, main, plan_batches
from .control_panel import ControlPanel, PanelState
from .preview_panel import PreviewPanel, default_metrics_line
from .range_slider import RangeModel, RangeSlider

__all__ = [
    "AejpegApp", "main", "plan_batches", "ControlPanel", "PanelState",
    "PreviewPanel", "default_metrics_line", "RangeModel", "RangeSlider",
]
