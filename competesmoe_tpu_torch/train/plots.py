"""Plot types for the metric logger (copy of competesmoe_tpu/train/plots.py):
Histogram, Heatmap, XYChart, ConfusionMatrix and TextPlot, after the
reference's CustomPlot zoo. `log_plots` always writes one JSON record of
the plots into the logger's JSONL history (the same record as JAX's),
and renders them to TensorBoard and W&B where the logger has those
sinks. matplotlib is imported only to render an image; without it the
plots keep their JSON form.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class CustomPlot:
    """Base plot: subclasses implement the three sinks."""

    def to_json(self) -> Dict[str, Any]:
        raise NotImplementedError

    def to_tensorboard(self, name: str, writer, step: int) -> None:
        pass

    def to_wandb(self):
        return None

    def _fig_to_array(self, fig) -> Optional[np.ndarray]:
        try:
            import matplotlib
            matplotlib.use("Agg")
            fig.canvas.draw()
            buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
            import matplotlib.pyplot as plt
            plt.close(fig)
            return buf
        except Exception:
            return None


@dataclasses.dataclass
class Histogram(CustomPlot):
    """Value histogram (plot.py:59-72)."""

    values: Sequence[float]
    bins: int = 64

    def to_json(self):
        hist, edges = np.histogram(np.asarray(self.values, np.float64),
                                   bins=self.bins)
        return {"type": "histogram", "hist": hist.tolist(),
                "edges": edges.tolist()}

    def to_tensorboard(self, name, writer, step):
        writer.add_histogram(name, np.asarray(self.values), step)

    def to_wandb(self):
        import wandb
        return wandb.Histogram(np.asarray(self.values))


@dataclasses.dataclass
class Heatmap(CustomPlot):
    """2-D matrix heatmap with optional axis labels (plot.py:93-130) —
    e.g. per-layer expert-usage matrices."""

    map: np.ndarray
    xlabel: str = ""
    ylabel: str = ""
    x_marks: Optional[List[str]] = None
    y_marks: Optional[List[str]] = None

    def _render(self):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(
            figsize=(max(4, 0.25 * np.asarray(self.map).shape[1]),
                     max(3, 0.25 * np.asarray(self.map).shape[0])))
        im = ax.imshow(np.asarray(self.map), aspect="auto",
                       cmap="viridis")
        fig.colorbar(im, ax=ax)
        ax.set_xlabel(self.xlabel)
        ax.set_ylabel(self.ylabel)
        if self.x_marks:
            ax.set_xticks(range(len(self.x_marks)),
                          labels=self.x_marks, rotation=45)
        if self.y_marks:
            ax.set_yticks(range(len(self.y_marks)), labels=self.y_marks)
        fig.tight_layout()
        return fig

    def to_json(self):
        return {"type": "heatmap",
                "map": np.asarray(self.map, np.float64).tolist(),
                "xlabel": self.xlabel, "ylabel": self.ylabel}

    def to_tensorboard(self, name, writer, step):
        try:
            img = self._fig_to_array(self._render())
        except Exception:
            img = None
        if img is not None:
            writer.add_image(name, img, step, dataformats="HWC")

    def to_wandb(self):
        try:
            import wandb
            return wandb.Image(self._fig_to_array(self._render()))
        except Exception:
            return None


@dataclasses.dataclass
class XYChart(CustomPlot):
    """Named line series (plot.py:131-170)."""

    curves: Dict[str, Sequence]   # name -> [(x, y), ...] or [y, ...]
    xlabel: str = ""
    ylabel: str = ""

    def _points(self, series):
        arr = np.asarray(series, np.float64)
        if arr.ndim == 1:
            return np.stack([np.arange(arr.size), arr], 1)
        return arr

    def to_json(self):
        return {"type": "xychart",
                "curves": {k: self._points(v).tolist()
                           for k, v in self.curves.items()},
                "xlabel": self.xlabel, "ylabel": self.ylabel}

    def to_tensorboard(self, name, writer, step):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots()
            for label, series in self.curves.items():
                pts = self._points(series)
                ax.plot(pts[:, 0], pts[:, 1], label=label)
            ax.set_xlabel(self.xlabel)
            ax.set_ylabel(self.ylabel)
            ax.legend()
            img = self._fig_to_array(fig)
        except Exception:
            img = None
        if img is not None:
            writer.add_image(name, img, step, dataformats="HWC")


@dataclasses.dataclass
class ConfusionMatrix(CustomPlot):
    """Row-normalized confusion matrix (plot.py:171-220)."""

    matrix: np.ndarray
    class_names: Optional[List[str]] = None

    def to_json(self):
        m = np.asarray(self.matrix, np.float64)
        norm = m / np.maximum(m.sum(1, keepdims=True), 1e-9)
        return {"type": "confusion_matrix", "matrix": norm.tolist(),
                "classes": self.class_names}

    def to_tensorboard(self, name, writer, step):
        Heatmap(map=np.asarray(self.matrix), xlabel="predicted",
                ylabel="true", x_marks=self.class_names,
                y_marks=self.class_names).to_tensorboard(name, writer,
                                                         step)


@dataclasses.dataclass
class TextPlot(CustomPlot):
    """Free text (plot.py Text)."""

    text: str

    def to_json(self):
        return {"type": "text", "text": self.text}

    def to_tensorboard(self, name, writer, step):
        writer.add_text(name, self.text, step)


def log_plots(logger, step: int, plots: Dict[str, CustomPlot]) -> None:
    """Route plots through a MetricLogger's sinks: the JSON record always
    (through the logger, so the async logger orders it with its other
    records), TB and W&B when attached."""
    rec = {"step": int(step), "plots": {}}
    for name, plot in plots.items():
        rec["plots"][name] = plot.to_json()
        if getattr(logger, "_tb", None) is not None:
            try:
                plot.to_tensorboard(name, logger._tb, step)
            except Exception:
                pass
        if getattr(logger, "_wandb", None) is not None:
            try:
                obj = plot.to_wandb()
                if obj is not None:
                    logger._wandb.log({name: obj}, step=step)
            except Exception:
                pass
    logger.write_record(rec)
