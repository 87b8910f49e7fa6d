"""Dataset and host loading pipeline (the port of the JAX package's
``data/dataset.py``): scene directories of per-frame ``.npz`` files, the
one-time conversion of Mantaflow ``.bin`` pairs into them, and a threaded
prefetch iterator that overlaps the host's file reads with the device's
work.

Scene layout (the same files the JAX package reads and writes):
  <root>/<prefix>/<scene 6-digit>/<frame 6-digit>.npz
each holding the ``Sample`` fields.
"""
import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, NamedTuple

import numpy as np
import torch

from .manta_io import load_manta_file


class Sample(NamedTuple):
    p_div: np.ndarray
    U_div: np.ndarray
    flags: np.ndarray
    density_div: np.ndarray
    p_target: np.ndarray
    U_target: np.ndarray
    density_target: np.ndarray


class FluidDataset:
    """Indexable frame collection over scene directories."""

    def __init__(self, root: str, prefix: str = "tr"):
        self.base = os.path.join(root, prefix)
        if not os.path.isdir(self.base):
            raise FileNotFoundError(self.base)
        self.files: List[str] = []
        for scene in sorted(os.listdir(self.base)):
            sdir = os.path.join(self.base, scene)
            if not os.path.isdir(sdir):
                continue
            self.files += [os.path.join(sdir, fn)
                           for fn in sorted(os.listdir(sdir))
                           if fn.endswith(".npz")]
        if not self.files:
            raise RuntimeError(f"no preprocessed frames under {self.base}")
        with np.load(self.files[0]) as z:
            self.h, self.w = z["flags"].shape

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Sample:
        with np.load(self.files[idx]) as z:
            return Sample(**{k: z[k] for k in Sample._fields})

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True,
                prefetch: int = 2) -> Iterator[Sample]:
        """Batches of stacked samples, read by a worker thread up to
        ``prefetch`` ahead; the order is numpy's shuffle of ``seed``, as
        in the JAX package. A worker's exception is raised here."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        n_batches = (len(order) // batch_size if drop_last
                     else -(-len(order) // batch_size))
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def worker():
            try:
                for bi in range(n_batches):
                    idxs = order[bi * batch_size: (bi + 1) * batch_size]
                    samples = [self[int(i)] for i in idxs]
                    put(Sample(*[np.stack([getattr(s, f) for s in samples])
                                 for f in Sample._fields]))
                put(None)
            except Exception as e:  # handed to the consumer, raised there
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)


def preprocess_manta_scenes(data_dir: str, dataset: str, prefix: str,
                            out_root: str, save_dt: int = 4,
                            steps_per_scene: int = 64, n_workers: int = 4):
    """Convert Mantaflow ``.bin`` scene dumps into the ``.npz`` layout: for
    each kept frame t (every ``save_dt``-th), ``NNNNNN.bin`` (the projected
    target) and ``NNNNNN_divergent.bin`` (the input) become one Sample.
    Writes ``preprocessed_<dataset>_<prefix>.json`` beside the scenes."""
    base = os.path.join(data_dir, dataset, prefix)
    scenes = sorted(d for d in os.listdir(base)
                    if os.path.isdir(os.path.join(base, d)))

    def convert(scene: str):
        sdir = os.path.join(base, scene)
        odir = os.path.join(out_root, prefix, scene)
        os.makedirs(odir, exist_ok=True)
        for step in range(steps_per_scene):
            t = step * save_dt
            tgt = os.path.join(sdir, f"{t:06d}.bin")
            div = os.path.join(sdir, f"{t:06d}_divergent.bin")
            if not (os.path.isfile(tgt) and os.path.isfile(div)):
                continue
            p_t, U_t, flags_t, rho_t, _ = load_manta_file(tgt)
            p_d, U_d, flags_d, rho_d, _ = load_manta_file(div)
            if not (flags_t == flags_d).all():
                raise ValueError(f"flag mismatch in {scene}/{t}")
            np.savez(os.path.join(odir, f"{t:06d}.npz"), p_div=p_d,
                     U_div=U_d, flags=flags_d, density_div=rho_d,
                     p_target=p_t, U_target=U_t, density_target=rho_t)

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        list(ex.map(convert, scenes))
    sample_scene = os.path.join(out_root, prefix, scenes[0])
    first = sorted(os.listdir(sample_scene))[0]
    with np.load(os.path.join(sample_scene, first)) as z:
        h, w = z["flags"].shape
    with open(os.path.join(out_root,
                           f"preprocessed_{dataset}_{prefix}.json"), "w") as f:
        json.dump({"data": ["pDiv", "UDiv", "flagsDiv", "densityDiv"],
                   "target": ["p", "U", "density"], "is3D": False,
                   "nx": w, "ny": h, "nz": 1}, f)


def sample_to_batch(sample: Sample, device="cuda"):
    """Host Sample -> trainer ``Batch`` of tensors on ``device`` (float32,
    flags int32)."""
    from ..train.trainer import Batch

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return Batch(p_div=t(sample.p_div), U_div=t(sample.U_div),
                 flags=t(sample.flags, torch.int32),
                 density_div=t(sample.density_div),
                 p_target=t(sample.p_target), U_target=t(sample.U_target),
                 density_target=t(sample.density_target))
