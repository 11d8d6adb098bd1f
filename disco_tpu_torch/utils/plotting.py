"""Shared room top-view drawing (the port's copy of
``disco_tpu/utils/plotting.py``) — the one renderer behind
``disco_tpu_torch.sim.geometry.RoomSetup.plot`` (reference ``plot_room``,
room_setups.py:238-253) and ``disco_tpu_torch.enhance.inference.plot_conf``
(reference speech_enhancement/utils.py:141-172).

Object-oriented matplotlib API throughout, imported where a figure is
drawn: the process-global pyplot backend is never touched, so headless
corpus jobs can render thousands of figures without state leaks.
"""
from __future__ import annotations

import numpy as np


def draw_room_topview(length, width, mics, sources, node_positions, label_offset=1.02):
    """Render a room top view and return the matplotlib Figure.

    Args:
      length, width: room floor dimensions (m).
      mics: (3, n_mics) microphone positions — the pra column layout.
      sources: (n_sources, 3) source positions (rows).
      node_positions: (n_nodes, >=2) per-node label anchor positions
        (node centers, or each node's first mic).
      label_offset: multiplicative offset of the text labels.
    """
    from matplotlib.figure import Figure
    from matplotlib.patches import Rectangle

    mics = np.asarray(mics)
    sources = np.asarray(sources)
    node_positions = np.asarray(node_positions)

    f = Figure()
    ax = f.add_subplot()
    ax.add_patch(Rectangle((0, 0), length, width, fill=False, linewidth=3))
    ax.plot(mics[0, :], mics[1, :], "x", label="mics")
    ax.plot(sources[:, 0], sources[:, 1], "o", label="sources")
    for i_n, c in enumerate(node_positions):
        ax.text(label_offset * c[0], label_offset * c[1], f"Node {i_n + 1}", fontsize=10)
    for i_s, p in enumerate(sources):
        ax.text(label_offset * p[0], label_offset * p[1], f"Source {i_s + 1}", fontsize=10)
    ax.axis("equal")
    ax.set(xlim=(-1, length + 1), ylim=(-1, width + 1))
    ax.legend(loc="upper right", fontsize=8)
    return f
