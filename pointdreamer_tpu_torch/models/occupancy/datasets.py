"""Occupancy-training datasets (twin of models/occupancy/datasets.py).

Reference: models/POCO/datasets/shapenet.py (:9-216): per-shape npy files
(`pc_kaolin/<id>.npy` surface points, `points/<id>.npz` occupancy query
samples), split lists under `splits/*.txt`, test split shuffled with seed
3407 (:33).  Plus the synthetic sphere generator used by tests
(train.synthetic_occupancy_batch).

Every item is resampled to fixed sizes (n_points/n_queries), so the
clouds of a batch stack.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


class ShapeNetOccupancy:
    """Loads the POCO ShapeNet data layout."""

    def __init__(self, root: str, split: str = "training",
                 n_points: int = 3000, n_queries: int = 2048,
                 categories: Optional[List[str]] = None, seed: int = 3407):
        self.root = root
        self.n_points = n_points
        self.n_queries = n_queries
        split_file = os.path.join(root, "splits", f"{split}.txt")
        if os.path.exists(split_file):
            with open(split_file) as f:
                items = [l.strip() for l in f if l.strip()]
        else:  # directory scan fallback
            items = sorted(
                os.path.splitext(f)[0]
                for f in os.listdir(os.path.join(root, "pc"))
            ) if os.path.isdir(os.path.join(root, "pc")) else []
        if categories:
            items = [i for i in items
                     if any(i.startswith(c) for c in categories)]
        if split == "test":
            rng = np.random.default_rng(seed)  # reference shapenet.py:33
            rng.shuffle(items)
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        name = self.items[i]
        pts = np.load(os.path.join(self.root, "pc", name + ".npy"))
        qz = np.load(os.path.join(self.root, "points", name + ".npz"))
        queries = qz["points"].astype(np.float32)
        occ = np.unpackbits(qz["occupancies"])[: len(queries)] \
            if qz["occupancies"].dtype == np.uint8 else qz["occupancies"]
        rng = np.random.default_rng(i)
        pi = rng.choice(len(pts), self.n_points,
                        replace=len(pts) < self.n_points)
        qi = rng.choice(len(queries), self.n_queries,
                        replace=len(queries) < self.n_queries)
        return (pts[pi, :3].astype(np.float32),
                queries[qi], occ[qi].astype(np.int32))

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0, transform=None
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        rng = np.random.default_rng(seed)
        order = np.arange(len(self))
        while True:
            if shuffle:
                rng.shuffle(order)
            for s in range(0, len(order) - batch_size + 1, batch_size):
                items = [self[int(j)] for j in order[s:s + batch_size]]
                if transform is not None:
                    items = [transform(*it, rng) for it in items]
                yield tuple(np.stack(x) for x in zip(*items))


def _resample(arr: np.ndarray, n: int, rng) -> np.ndarray:
    idx = rng.choice(len(arr), n, replace=len(arr) < n)
    return arr[idx]


class _BatchesMixin:
    """Fixed-shape batching shared by all loaders.  `transform`
    is an occupancy.transforms callable applied per sample (reference
    lightconvpoint/utils/transforms.py wiring)."""

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0, transform=None
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        rng = np.random.default_rng(seed)
        order = np.arange(len(self))
        while True:
            if shuffle:
                rng.shuffle(order)
            for s in range(0, len(order) - batch_size + 1, batch_size):
                items = [self[int(j)] for j in order[s:s + batch_size]]
                if transform is not None:
                    items = [transform(*it, rng) for it in items]
                yield tuple(np.stack(x) for x in zip(*items))


# reference variant_directory per named dataset class
# (abc_test.py:95-119, famous_test.py:93-138, thingi10k_test.py:97-142)
POINT2SURF_VARIANTS = {
    "ABC": "abc", "ABCNoiseFree": "abc_noisefree",
    "ABCExtraNoise": "abc_extra_noisy",
    "FamousTest": "famous_original",
    "FamousTestNoiseFree": "famous_noisefree",
    "FamousTestExtraNoisy": "famous_extra_noisy",
    "FamousTestSparse": "famous_sparse",
    "FamousTestDense": "famous_dense",
    "Thingi10kTest": "thingi10k_scans_original",
    "Thingi10kTestNoiseFree": "thingi10k_scans_noisefree",
    "Thingi10kTestExtraNoisy": "thingi10k_scans_extra_noisy",
}


class Point2SurfDataset(_BatchesMixin):
    """The point2surf data layout shared by the ABC / FAMOUS / Thingi10k
    datasets (reference datasets/abc.py:56-102, abc_test.py:74-94,
    famous_test.py, thingi10k_test.py):

        <root>/<variant>/{trainset,valset,testset}.txt
        <root>/<variant>/04_pts/<name>.xyz.npy          surface points
        <root>/<variant>/05_query_pts/<name>.ply.npy    query points
        <root>/<variant>/05_query_dist/<name>.ply.npy   signed distances

    Occupancy label = (dist > 0) as in abc.py:91.  Test splits carry only
    surface points (abc_test.py:74-94).  `variant` accepts either a
    directory name or a reference class name from POINT2SURF_VARIANTS.
    """

    SPLIT_FILES = {"training": "trainset.txt", "validation": "valset.txt",
                   "test": "testset.txt"}

    def __init__(self, root: str, variant: str = "abc",
                 split: str = "test", n_points: int = 3000,
                 n_queries: int = 2048, dataset_size: Optional[int] = None):
        variant = POINT2SURF_VARIANTS.get(variant, variant)
        self.root = os.path.join(root, variant)
        self.n_points = n_points
        self.n_queries = n_queries
        self.split = split
        split_file = os.path.join(self.root, self.SPLIT_FILES[split])
        with open(split_file) as f:
            names = sorted(l.strip() for l in f if l.strip())
        if dataset_size is not None:
            names = names[:dataset_size]
        self.items = names

    def __len__(self):
        return len(self.items)

    def object_name(self, i: int) -> str:
        return self.items[i]

    def __getitem__(self, i: int):
        name = self.items[i]
        pts = np.load(os.path.join(self.root, "04_pts",
                                   name + ".xyz.npy")).astype(np.float32)
        rng = np.random.default_rng(i)
        pts = _resample(pts[:, :3], self.n_points, rng)
        qp_file = os.path.join(self.root, "05_query_pts",
                               name + ".ply.npy")
        if self.split == "test" or not os.path.exists(qp_file):
            # test sets ship no occupancy supervision (abc_test.py:84-86)
            return (pts, np.zeros((1, 3), np.float32),
                    np.ones((1,), np.int32))
        queries = np.load(qp_file).astype(np.float32)
        dist = np.load(os.path.join(self.root, "05_query_dist",
                                    name + ".ply.npy"))
        occ = (dist > 0).astype(np.int32)
        qi = rng.choice(len(queries), self.n_queries,
                        replace=len(queries) < self.n_queries)
        return pts, queries[qi], occ[qi]


class SyntheticRoomsOccupancy(_BatchesMixin):
    """ShapeNet synthetic rooms (reference datasets/synthetic_room.py):
    <root>/room*/<scene>/pointcloud/*.npz ('points') and
    points_iou/*.npz ('points' + packed 'occupancies')."""

    def __init__(self, root: str, split: str = "training",
                 n_points: int = 10000, n_queries: int = 2048,
                 dataset_size: Optional[int] = None, seed: int = 0):
        import glob

        self.n_points = n_points
        self.n_queries = n_queries
        scenes = []
        for d in sorted(glob.glob(os.path.join(root, "room*"))):
            lst = os.path.join(d, f"{split[:5]}.lst")   # train/val/test.lst
            if os.path.exists(lst):
                with open(lst) as f:
                    scenes += [os.path.join(d, l.strip())
                               for l in f if l.strip()]
            else:
                scenes += sorted(
                    os.path.join(d, s) for s in os.listdir(d)
                    if os.path.isdir(os.path.join(d, s)))
        if dataset_size is not None:
            scenes = scenes[:dataset_size]
        self.items = scenes
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        import glob

        scene = self.items[i]
        rng = np.random.default_rng(i)
        pc_files = sorted(glob.glob(os.path.join(scene,
                                                 "pointcloud", "*.npz")))
        pc = np.load(pc_files[int(self._rng.integers(len(pc_files)))])
        pts = _resample(pc["points"].astype(np.float32),
                        self.n_points, rng)
        iou_files = sorted(glob.glob(os.path.join(scene,
                                                  "points_iou", "*.npz")))
        iou = np.load(iou_files[int(self._rng.integers(len(iou_files)))])
        queries = iou["points"].astype(np.float32)
        occ = np.unpackbits(iou["occupancies"])[: len(queries)]
        qi = rng.choice(len(queries), self.n_queries,
                        replace=len(queries) < self.n_queries)
        return pts, queries[qi], occ[qi].astype(np.int32)


class SceneNetPoints(_BatchesMixin):
    """SceneNet scene clouds (reference datasets/scenenet.py:100-123):
    <root>/<scene>.xyz text files with xyz + normals; eval-only (no
    occupancy supervision)."""

    def __init__(self, root: str, filenames: Optional[List[str]] = None,
                 n_points: int = 10000):
        self.root = root
        self.n_points = n_points
        if filenames is None:
            filenames = sorted(
                os.path.join(dp, f)[len(root):].lstrip("/")[:-4]
                for dp, _, fs in os.walk(root)
                for f in fs if f.endswith(".xyz"))
        self.items = filenames

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        data = np.loadtxt(os.path.join(self.root, self.items[i] + ".xyz"),
                          dtype=np.float32)
        rng = np.random.default_rng(i)
        data = _resample(data, self.n_points, rng)
        return (data[:, :3], data[:, 3:6],
                np.zeros((1, 3), np.float32))       # pos, normals, queries
