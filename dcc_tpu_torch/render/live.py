"""Live viewer of the rendered frames in a matplotlib window (counterpart of
:class:`dcc_tpu.render.live.LiveViewer`).

The Learner shows each render interval's frames through it when
``render_live`` is set. matplotlib is imported when a viewer is made, not
with this module, and its absence raises. Under a non-GUI backend (Agg and
the other file backends) no window can open: ``show`` then only records the
frame in ``last_frame`` and ``interactive`` is False.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_NON_GUI = {"agg", "pdf", "svg", "ps", "pgf", "cairo", "template"}


class LiveViewer:
    """Incremental frame viewer over matplotlib's interactive mode."""

    def __init__(self, title: str = "dcc_tpu_torch"):
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError("render_live needs matplotlib, which is not installed; "
                              "set render_live=false") from e
        self.title = title
        self.last_frame: Optional[np.ndarray] = None
        self._fig = self._im = None
        # GUI backends such as TkAgg contain "agg": test membership, not substrings
        self.interactive = matplotlib.get_backend().lower() not in _NON_GUI
        if self.interactive:
            import matplotlib.pyplot as plt

            self._plt = plt
            plt.ion()

    def show(self, frame: np.ndarray) -> None:
        """Display one (H, W, 3) uint8 frame (recorded in ``last_frame``)."""
        self.last_frame = np.asarray(frame)
        if not self.interactive:
            return
        plt = self._plt
        if self._fig is None:
            self._fig, ax = plt.subplots(num=self.title)
            ax.set_axis_off()
            self._im = ax.imshow(self.last_frame)
        else:
            self._im.set_data(self.last_frame)
        self._fig.canvas.draw_idle()
        plt.pause(0.001)  # processes GUI events

    def close(self) -> None:
        if self._fig is not None:
            self._plt.close(self._fig)
            self._fig = None
