"""Host-side training data pipeline (counterpart of ``disco_tpu/nn/data.py``;
reference dnn/data/datasets.py, dnn/data/lists_to_load.py,
dnn/utils.py:74-140).

The reference feeds a torch DataLoader from RAM-resident magnitude STFTs;
here, as in the JAX package, the same windowing semantics produce numpy
batches that ``nn.training.fit`` copies to the card
(``device.prefetch_to_device``).  This is the JAX package's numpy code: the
same seeded generator draws the same windows, so both packages give
byte-identical batches.  Semantics kept 1:1 (datasets.py:40-222):

* items are (segment, start-frame) windows of ``win_len`` frames with hop
  ``win_hop`` and a random sub-hop jitter per draw (datasets.py:105-118);
* each item picks a random *local node*; the input stacks the local node's
  reference-channel magnitude STFT with the other nodes' compressed z
  signals, local node rolled last (datasets.py:120-151);
* labels are the saved ideal-mask frames of the local node
  (datasets.py:153-162);
* the first second (silence prepended at generation) is dropped
  (datasets.py:73,81);
* ``stack_axis`` 0 = single-channel, 1 = stack z's on the frequency axis
  (2-D nets), 2 = stack on a channel axis (3-D CRNN) (datasets.py:60-66).

``RandomDataset`` is the corpus-free fake for smoke tests
(datasets.py:13-36).  ``DiscoPartialDataset`` keeps only the z's in RAM and
reads reference channels / masks lazily per item (datasets.py:165-221).
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from disco_tpu_torch.io.atomic import atomic_write
from disco_tpu_torch.io.layout import DatasetLayout

TRAIN_DUR = 11  # seconds (datasets.py:6)
FS = 16000  # Hz (datasets.py:7)


class RandomDataset:
    """Random-tensor fake dataset for plumbing smoke tests
    (reference datasets.py:13-36)."""

    def __init__(self, input_shape, output_shape, length=1000, rng=None):
        self.input_shape = input_shape
        self.output_shape = output_shape
        self.length = length
        self.rng = rng or np.random.default_rng()

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        x = self.rng.random(self.input_shape).astype("float32")
        y = self.rng.random(self.output_shape).astype("float32")
        return x, y


class DiscoDataset:
    """Windowed magnitude-STFT dataset, everything RAM-resident
    (reference datasets.py:40-162)."""

    n_nodes = 4

    def __init__(
        self,
        lists_to_load,
        stack_axis=0,
        z_nodes=None,
        fft_len=512,
        fft_hop=256,
        win_len=21,
        win_hop=8,
        rng=None,
    ):
        self.n_fft = fft_len
        self.n_hop = fft_hop
        self.n_freq = fft_len // 2 + 1
        self.win_len = win_len
        self.win_hop = win_hop
        self.segs_to_load = [list(l) for l in lists_to_load]
        self.n_ch = len(self.segs_to_load) - 1
        assert stack_axis in (0, 1, 2), "stack_axis: 0 (SC), 1 (freq-stacked MC) or 2 (channel-stacked MC)"
        self.stack_axis = stack_axis
        self.z_nodes = min(stack_axis, 1) * (self.n_nodes - 1) if z_nodes is None else z_nodes
        self.rng = rng or np.random.default_rng()

        self.data, self.first_seq_frame, self.win_per_seg, self.n_frames = self.load_data()
        self.n_cum = np.cumsum([0] + list(self.win_per_seg))

    # -- loading -----------------------------------------------------------
    def _frame_geometry(self):
        first_seq_frame = int(np.ceil(FS / self.n_hop))
        # +3 because of the centered STFT convention (datasets.py:73)
        n_frames_max = (TRAIN_DUR * FS - self.n_fft) // self.n_hop + 3 - first_seq_frame
        return first_seq_frame, n_frames_max

    def _load_rows(self, rows):
        """Load |STFT| of the given list rows into one (n_rows, n_seg, F, T)
        RAM array, dropping the first second (datasets.py:71-87), on the
        threaded loader (:mod:`disco_tpu_torch.nn.fastload`)."""
        from disco_tpu_torch.nn import fastload

        rows = list(rows)
        first_seq_frame, n_frames_max = self._frame_geometry()
        n_seg = len(self.segs_to_load[0])
        data = np.zeros((len(rows), n_seg, self.n_freq, n_frames_max), "float32")
        paths = [self.segs_to_load[row][i_seg] for row in rows for i_seg in range(n_seg)]
        flat = data.reshape(len(rows) * n_seg, self.n_freq, n_frames_max)
        _, frames = fastload.load_abs_batch(
            paths, self.n_freq, n_frames_max, skip_cols=first_seq_frame, out=flat
        )
        # per-segment geometry from the first row (datasets.py:83-86)
        n_frames = frames[:n_seg].astype("int")
        win_per_seg = (n_frames - self.win_len) // self.win_hop + 1
        return data, first_seq_frame, win_per_seg, n_frames

    def load_data(self):
        return self._load_rows(range(len(self.segs_to_load)))

    # -- item access -------------------------------------------------------
    def __len__(self):
        return int(sum(self.win_per_seg))

    def get_item_indices(self, item):
        """item → (segment k, first frame m) with random sub-hop jitter
        (datasets.py:105-118)."""
        k = int(np.searchsorted(self.n_cum, item, side="right")) - 1
        m = int(item - self.n_cum[k]) * self.win_hop + int(self.rng.integers(self.win_hop))
        m = min(m, int(self.n_frames[k]) - self.win_len)
        return k, m

    def _z_order(self, local_node):
        """Compressed-channel visit order: local node rolled last; a single
        z channel is drawn randomly among the others (datasets.py:134-140)."""
        z_chs = np.arange(self.n_nodes)
        if self.z_nodes == 1:
            z_chs = np.delete(z_chs, local_node)
            return self.rng.permutation(z_chs)
        return np.roll(z_chs, self.n_nodes - 1 - local_node)

    @property
    def _n_zsigs(self):
        # rows are [4 refs | 4 per zsig ... | 4 masks] (dnn/utils.py:98)
        return len(self.segs_to_load) // self.n_nodes - 2

    def _ref_window(self, local_node, k, m):
        return self.data[local_node, k, :, m : m + self.win_len]

    def _z_window(self, i_zsig, z_ch, k, m):
        return self.data[self.n_nodes * (i_zsig + 1) + z_ch, k, :, m : m + self.win_len]

    def get_mask_frames(self, local_node, k, m):
        return self.data[-self.n_nodes + local_node, k, :, m : m + self.win_len]

    def get_subwindow(self, local_node, k, m):
        """Input window: [local ref ‖ z's of other nodes] stacked per
        ``stack_axis``, plus the local mask label (datasets.py:120-151)."""
        mixt = [self._ref_window(local_node, k, m)]
        for z_ch in self._z_order(local_node)[: self.z_nodes]:
            for i_zsig in range(self._n_zsigs):
                mixt.append(self._z_window(i_zsig, int(z_ch), k, m))
        mixt = np.squeeze(np.array(mixt))
        if self.stack_axis == 1:
            mixt = np.concatenate([mixt[i] for i in range(mixt.shape[0])], axis=0)
        return np.abs(mixt), self.get_mask_frames(local_node, k, m)

    def __getitem__(self, item):
        k, m = self.get_item_indices(item)
        local_node = int(self.rng.integers(self.n_nodes))
        mixture, mask = self.get_subwindow(local_node, k, m)
        # (…, F, T) → (…, T, F) (datasets.py:102-103)
        return np.swapaxes(mixture, -2, -1), mask.T


class DiscoPartialDataset(DiscoDataset):
    """RAM holds only the z's; reference channels and masks are np.load-ed
    lazily per item (reference datasets.py:165-221)."""

    def load_data(self):
        rows = range(self.n_nodes, len(self.segs_to_load) - self.n_nodes)
        return self._load_rows(rows)

    def _ref_window(self, local_node, k, m):
        m_ = m + self.first_seq_frame
        return np.abs(np.load(self.segs_to_load[local_node][k])[:, m_ : m_ + self.win_len]).astype("float32")

    def _z_window(self, i_zsig, z_ch, k, m):
        return self.data[self.n_nodes * i_zsig + z_ch, k, :, m : m + self.win_len]

    def get_mask_frames(self, local_node, k, m):
        m_ = m + self.first_seq_frame
        return np.load(self.segs_to_load[-self.n_nodes + local_node][k])[:, m_ : m_ + self.win_len].astype("float32")


def batch_iterator(dataset, batch_size, shuffle=True, rng=None, drop_last=False):
    """Yield (x, y) numpy batches — the DataLoader equivalent feeding the
    train step."""
    rng = rng or np.random.default_rng()
    order = rng.permutation(len(dataset)) if shuffle else np.arange(len(dataset))
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        xs, ys = zip(*(dataset[int(i)] for i in idx))
        yield np.stack(xs), np.stack(ys)


# -- input lists (reference dnn/utils.py:74-140, dnn/data/lists_to_load.py) --
def get_input_lists(
    path_to_data,
    rirs_to_get,
    scenes=None,
    snr_range=None,
    noise_to_get="ssn",
    ref_channel=1,
    z_sigs=None,
    z_file="oracle",
    n_nodes=4,
    rng=None,
):
    """Per-signal lists of .npy paths: [4 mixture refs | 4 per z_sig |
    4 masks], one entry per RIR with a random scene and noise draw
    (reference dnn/utils.py:74-140)."""
    rng = rng or np.random.default_rng()
    scenes = ["random"] if scenes is None else scenes
    scenes = [scenes] if not isinstance(scenes, list) else scenes
    snr_range = [0, 6] if snr_range is None else snr_range
    z_sigs = [] if z_sigs is None else ([z_sigs] if not isinstance(z_sigs, list) else z_sigs)
    noise_pool = {
        "ssn": ["ssn"], "it": ["it"], "fs": ["fs"],
        "noit": ["ssn", "fs"], "all": ["ssn", "it", "fs"],
    }[noise_to_get]

    out = [[] for _ in range(n_nodes + len(z_sigs) * n_nodes + n_nodes)]
    for rir in rirs_to_get:
        scene = scenes[int(rng.integers(len(scenes)))]
        noise = noise_pool[int(rng.integers(len(noise_pool)))]
        lay = DatasetLayout(path_to_data, scene, "train")
        for node in range(n_nodes):
            ch = ref_channel + n_nodes * node
            out[node].append(str(lay.stft_processed(snr_range, "mixture", rir, ch, noise=noise, normed=True)))
            out[-n_nodes + node].append(str(lay.mask_processed(snr_range, rir, ch, noise)))
        for i_zsig, zsig in enumerate(z_sigs):
            for node in range(n_nodes):
                out[n_nodes + node + i_zsig * n_nodes].append(
                    str(lay.stft_z(z_file, snr_range, zsig, rir, node + 1, noise, normed=True))
                )
    return out


def write_input_lists(lists, folder):
    """Persist lists as one txt file per signal row — the rsync
    ``--files-from`` staging format (reference lists_to_load.py:27-40)."""
    os.makedirs(folder, exist_ok=True)
    for i, row in enumerate(lists):
        # atomic: a torn list file still parses (any line prefix is a valid
        # list), so a crash here would silently starve the loader instead
        # of erroring on resume
        with atomic_write(Path(folder, f"list_{i}.txt"), "w") as fh:
            fh.write("\n".join(row) + "\n")


def load_input_lists(folder):
    """Load lists written by :func:`write_input_lists`
    (reference lists_to_load.py:11-24)."""
    files = sorted(Path(folder).glob("list_*.txt"), key=lambda p: int(p.stem.split("_")[1]))
    return [p.read_text().splitlines() for p in files]
