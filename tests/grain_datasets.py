"""numpy-only map-style datasets for the grain tests: grain's worker
processes unpickle them, so their module imports numpy alone."""

import numpy as np


class EpochKeyedDataset:
    """Items depend on (epoch, index), as the readers' epoch-keyed
    reference-sampling streams (``ShapeNetDataset.set_epoch``)."""

    def __init__(self, n):
        self.n, self._epoch = n, 0

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __getitem__(self, i):
        return {"x": np.asarray([1000.0 * self._epoch + i], np.float32), "i": np.int64(i)}


class GrainPairs:
    """Training pairs of 32x32 images, a function of (epoch, index), each
    carrying its index."""

    def __init__(self, n=32):
        self.n, self._epoch = n, 0

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __getitem__(self, i):
        rng = np.random.default_rng(1000 * self._epoch + int(i))
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        ang = rng.uniform(0, np.pi)
        mat = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * (k @ k)  # Rodrigues
        return {"query": rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32),
                "reference": rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32),
                "relativeR": mat[:2].reshape(6).astype(np.float32),
                "relativeR_inv": mat.T[:2].reshape(6).astype(np.float32),
                "_idx": np.asarray(int(i), np.int64)}
