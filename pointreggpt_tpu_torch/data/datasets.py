"""Host-side data for the port: 3DMatch frame records, the diffusion and
depth-correction training sets, the depth-correction test set, and a
prefetching batch loader.

Own copies of ``resolve_frame_record``, ``DepthDataset``,
``PairedDepthDataset``, ``TestDataset``, ``collate`` and ``PrefetchLoader``
from ``pointreggpt_tpu/data/datasets.py``, with the same contracts:

- :class:`DepthDataset` lists training frames from ``gt.log`` (one depth
  PNG path per line, relative to the RGB-D root) with their scene's
  ``camera-intrinsics.txt``; its h-flip is a pure function of
  ``(seed, epoch, index)`` through ``np.random.default_rng``.
- :class:`PairedDepthDataset` reads the (input, label) pairs that
  ``metadata/{subset}.json`` lists, with the keep mask
  ``|label - input| < 0.005``.
- :class:`TestDataset` reprojects the first frame of one fragment of a
  3DMatch pair into the other's view, on its device.
- :class:`PrefetchLoader` draws a fresh permutation per epoch from
  ``default_rng([seed, epoch])``, can start at ``start_epoch``, decodes in
  worker threads ahead of the consumer, re-raises a decode error in the
  consumer, and releases its thread when an iterator is abandoned. Its
  spans: the consumer's ``loader_wait`` on the queue, and on the
  producer's thread ``loader_decode`` and ``loader_collate``. In a
  data-parallel run every process walks the same batches and decodes
  only its own positions of each (``rows``).

Both packages draw with numpy, so for one seed their batches are the same
bit for bit. Batches are dicts of stacked numpy arrays, NHWC.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from pointreggpt_tpu_torch import resolve_device
from pointreggpt_tpu_torch.core import imageio16
from pointreggpt_tpu_torch.core.geometry import intrinsic_transform, reproject
from pointreggpt_tpu_torch.utils import profiling


def resolve_frame_record(data_root: str, folder: str, rel_path: str,
                         image_size: int, *, with_pose: bool = False):
    """``(depth01, intrinsic)`` or ``(depth01, pose, intrinsic)`` of the
    first frame of a fragment record."""
    info_path = os.path.join(data_root, rel_path.replace(".pth", ".info.txt"))
    with open(info_path, "r") as f:
        first = f.readlines()[0].strip()
    scene_name, seq_name, frame_start_idx, _ = first.split()
    scene_path = os.path.join(folder, scene_name)
    frame_path = os.path.join(
        scene_path, seq_name,
        "frame-{:0>6d}.depth.png".format(int(frame_start_idx)))
    image = imageio16.load_depth_model_space(frame_path, image_size)
    intrinsic = intrinsic_transform(
        np.loadtxt(os.path.join(scene_path, "camera-intrinsics.txt")),
        resize=image_size, centercrop=image_size,
    ).astype(np.float32)
    if with_pose:
        pose = np.loadtxt(frame_path.replace("depth.png", "pose.txt"))
        return image, pose, intrinsic
    return image, intrinsic


class DepthDataset:
    """Diffusion training set: single depth frames + intrinsics.

    Args:
        folder: 3DMatch-RGBD train root (scene dirs with seq subdirs).
        image_size: model resolution (256).
        gt_log: frame list, one path relative to ``folder`` per line.
        augment_horizontal_flip: random h-flip, decided per
            ``(seed, epoch, index)``.
    """

    def __init__(self, folder: str, image_size: int, *,
                 gt_log: str = "./dataset/3DMatch/metadata/gt.log",
                 augment_horizontal_flip: bool = False, seed: int = 0):
        self.folder = folder
        self.image_size = image_size
        self.augment_horizontal_flip = augment_horizontal_flip
        self.seed = seed
        with open(gt_log, "r") as f:
            self.paths: List[Path] = [Path(folder, line.strip())
                                      for line in f if line.strip()]
        self._intrinsic_cache: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.paths)

    def _scene_intrinsic(self, path: Path) -> np.ndarray:
        scene_path = path.parent.parent
        key = str(scene_path)
        if key not in self._intrinsic_cache:
            self._intrinsic_cache[key] = intrinsic_transform(
                np.loadtxt(Path(scene_path, "camera-intrinsics.txt")),
                resize=self.image_size, centercrop=self.image_size,
            ).astype(np.float32)
        return self._intrinsic_cache[key]

    def getitem_at_epoch(self, index: int,
                         epoch: int) -> Dict[str, np.ndarray]:
        """Item ``index`` as epoch ``epoch`` sees it: (h, w, 1) depth in
        [0, 1] and its (3, 3) intrinsic."""
        path = self.paths[index]
        flip = self.augment_horizontal_flip and (
            np.random.default_rng(
                (self.seed, int(epoch), index)).random() < 0.5)
        img = imageio16.load_depth_model_space(path, self.image_size,
                                               flip=flip)
        return {"img": img[..., None],
                "intrinsic": self._scene_intrinsic(path)}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.getitem_at_epoch(index, 0)


class PairedDepthDataset:
    """Depth-correction pairs: (h, w, 1) input and label depths in [0, 1]
    (raw PNG values x 1e-4, above 1 set to 0) and the keep mask
    ``|label - input| < 0.005`` as float32.

    Args:
        folder: root holding ``data/`` and ``metadata/{subset}.json``.
        subset: ``train`` or ``val``.
        image_size: the model's resolution (the PNGs are stored at it).
    """

    def __init__(self, folder: str, subset: str, image_size: int):
        self.folder = folder
        self.image_size = image_size
        with open(os.path.join(folder, f"metadata/{subset}.json"), "r") as f:
            self.metadata = list(json.load(f))

    def __len__(self) -> int:
        return len(self.metadata)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        meta = self.metadata[index]

        def load(name):
            raw = imageio16.read_depth_png(
                os.path.join(self.folder, "data", name)).astype(
                    np.float32) * 1e-4
            return np.where(raw > 1.0, 0.0, raw)

        input_img = load(meta["input_path"])
        label_img = load(meta["label_path"])
        mask = (np.abs(label_img - input_img) < 0.005).astype(np.float32)
        return {"input_img": input_img[..., None],
                "label_img": label_img[..., None],
                "mask": mask[..., None]}

    def getitem_at_epoch(self, index: int,
                         epoch: int) -> Dict[str, np.ndarray]:
        """Item ``index``; the pairs do not change with the epoch."""
        return self[index]


class TestDataset:
    """Depth-correction test inputs from 3DMatch test pairs.

    Item ``i`` of the first half reprojects the first frame of pair
    ``i``'s src fragment into its tgt view (relative pose
    ``inv(tgt_pose) @ src_pose``, :func:`reproject` on ``device``); the
    second half swaps src and tgt. Both images are kept only where the
    reprojection and the label are valid. Items are (h, w, 1) float32
    ``input_img`` and ``label_img`` in [0, 1].

    Args:
        info: ``{"src": [...], "tgt": [...]}`` fragment paths (``.pth``).
        folder: 3DMatch-RGBD test root.
        image_size: the model's resolution.
        data_root: root of the fragments' ``.info.txt`` files.
        device: where the reprojection runs (see ``resolve_device``).
    """

    def __init__(self, info: Dict[str, Sequence[str]], folder: str,
                 image_size: int, *,
                 data_root: str = "./dataset/indoor/data", device=None):
        self.info = info
        self.folder = folder
        self.image_size = image_size
        self.data_root = data_root
        self.device = resolve_device(device)

    def __len__(self) -> int:
        return len(self.info["src"]) + len(self.info["tgt"])

    def _frame_record(self, rel_path: str):
        return resolve_frame_record(self.data_root, self.folder, rel_path,
                                    self.image_size, with_pose=True)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        half = len(self) // 2
        src, tgt = self.info["src"], self.info["tgt"]
        if (index // half) % 2 == 1:
            src, tgt = tgt, src
        src_image, src_pose, intrinsic = self._frame_record(src[index % half])
        tgt_image, tgt_pose, _ = self._frame_record(tgt[index % half])
        relative = (np.linalg.inv(tgt_pose) @ src_pose).astype(np.float32)

        def on_device(a):
            return torch.from_numpy(np.ascontiguousarray(a[None])).to(
                self.device)

        depth_rpj, mask_rpj = reproject(on_device(src_image * 10.0),
                                        on_device(intrinsic),
                                        on_device(relative))
        input_img = depth_rpj[0].cpu().numpy() * 0.1
        mutual = mask_rpj[0].cpu().numpy() & (tgt_image > 0)
        input_img = np.where(mutual, input_img, 0.0).astype(np.float32)
        label_img = np.where(mutual, tgt_image, 0.0).astype(np.float32)
        return {"input_img": input_img[..., None],
                "label_img": label_img[..., None]}


def collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of example dicts into a batch dict."""
    return {k: np.stack([item[k] for item in items]) for k in items[0]}


class PrefetchLoader:
    """Shuffling (optionally infinite) batch iterator over a dataset with
    ``getitem_at_epoch``, decoding in a thread pool ahead of the consumer.

    Each ``__iter__`` takes the next epoch number (starting at
    ``start_epoch``); an infinite iterator walks on through the epochs
    after it.

    ``rows`` (data parallel): the positions within each global batch of
    ``batch_size`` that this process decodes, in order; every process
    draws the same permutation, and an item's flip depends on the item,
    not on the process that decodes it. None decodes the whole batch.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, infinite: bool = False,
                 num_workers: Optional[int] = None, prefetch: int = 2,
                 seed: int = 0, start_epoch: int = 0,
                 rows: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.infinite = infinite
        self.num_workers = max(1, num_workers or os.cpu_count() or 1)
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = int(start_epoch)
        self.rows = None if rows is None else [int(r) for r in rows]
        if self.rows is not None and (
                not drop_last or
                any(not 0 <= r < batch_size for r in self.rows)):
            raise ValueError(f"rows {self.rows} must be positions in "
                             f"batches of {batch_size} with drop_last")
        if drop_last and len(dataset) < batch_size:
            raise ValueError(
                f"dataset has {len(dataset)} examples < batch_size "
                f"{batch_size} with drop_last=True: no batch can be formed")

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _index_batches(self, start_epoch: int):
        """(epoch, indices) of every batch from ``start_epoch`` on."""
        epoch = start_epoch
        while True:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                np.random.default_rng([self.seed, epoch]).shuffle(idx)
            stop = (len(idx) // self.batch_size * self.batch_size
                    if self.drop_last else len(idx))
            for s in range(0, stop, self.batch_size):
                batch = idx[s:s + self.batch_size]
                yield epoch, list(batch if self.rows is None
                                  else batch[self.rows])
            epoch += 1
            if not self.infinite:
                return

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        from concurrent.futures import ThreadPoolExecutor

        start_epoch = self._epoch
        self._epoch = start_epoch + 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []
        # set when the consumer stops (exhausted, raised, or abandoned):
        # releases a producer blocked on a full queue
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for epoch, batch_idx in self._index_batches(start_epoch):
                        with profiling.span("loader_decode", epoch=epoch):
                            items = list(pool.map(
                                self.dataset.getitem_at_epoch, batch_idx,
                                [epoch] * len(batch_idx)))
                        with profiling.span("loader_collate"):
                            batch = collate(items)
                        if not put(batch):
                            return
            except BaseException as e:  # noqa: BLE001 - re-raised below
                error.append(e)
            finally:
                put(sentinel)

        threading.Thread(target=producer, daemon=True,
                         name="prgpt-prefetch").start()
        try:
            while True:
                with profiling.span("loader_wait"):
                    item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
