"""Subject/dataset sampling (a copy of brainfm_tpu/synth/sampler.py, which
is plain numpy: the port imports nothing of the JAX package).

The reference's probability-weighted data mixing: per-dataset
probabilities, epoch-seeded weighted choice per process, and the
per-dataset modality roulette. Host-side numpy; each process draws its own
decorrelated stream.
"""


from __future__ import annotations

import numpy as np


class WeightedSubjectSampler:
    """Epoch-seeded weighted sampling of (dataset, subject) with
    per-process decorrelation."""

    def __init__(self, dataset_sizes, dataset_probs=None, seed: int = 0,
                 process_index: int = 0, subject_weights=None):
        """`subject_weights`: optional per-dataset arrays of per-subject
        weights; None entries mean uniform."""
        self.sizes = list(dataset_sizes)
        n = len(self.sizes)
        probs = dataset_probs if dataset_probs else [1.0 / n] * n
        self.probs = np.asarray(probs, np.float64)
        self.probs = self.probs / self.probs.sum()
        self.subject_weights = []
        for i, w in enumerate(subject_weights or [None] * n):
            if w is None:
                self.subject_weights.append(None)
            else:
                w = np.asarray(w, np.float64)
                assert w.shape == (self.sizes[i],)
                self.subject_weights.append(w / w.sum())
        self.seed = seed
        self.process_index = process_index
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def sample(self, count: int):
        """Yield (dataset_idx, subject_idx) pairs for one epoch slice."""
        rng = np.random.default_rng(
            (self.seed, self.epoch, self.process_index))
        ds = rng.choice(len(self.sizes), size=count, p=self.probs)
        out = []
        for d in ds:
            w = self.subject_weights[d]
            if w is None:
                idx = rng.integers(self.sizes[d])
            else:
                idx = rng.choice(self.sizes[d], p=w)
            out.append((int(d), int(idx)))
        return out

    def sample_grouped(self, n_batches: int, batch_items: int):
        """Batch-grouped draw for sharded per-rank synthesis: one dataset
        per BATCH (weighted by dataset probs), `batch_items` independent
        weighted subject draws within it. The per-item marginal mixing
        distribution matches `sample`; only the within-batch grouping
        differs (all items of one SPMD synthesis program must share the
        dataset's static config). Returns [(dataset_idx, [subject_idx])]."""
        rng = np.random.default_rng(
            (self.seed, self.epoch, self.process_index, 1))
        ds = rng.choice(len(self.sizes), size=n_batches, p=self.probs)
        out = []
        for d in ds:
            w = self.subject_weights[d]
            if w is None:
                idxs = [int(i) for i in rng.integers(self.sizes[d],
                                                     size=batch_items)]
            else:
                idxs = [int(rng.choice(self.sizes[d], p=w))
                        for _ in range(batch_items)]
            out.append((int(d), idxs))
        return out


def choose_modality(rng: np.random.Generator, input_prob: dict,
                    available: set) -> str:
    """Modality roulette: one uniform draw tested against per-modality
    thresholds, falling through to 'synth'."""
    prob = rng.random()
    for mode in ("T1", "T2", "FLAIR", "CT"):
        if prob < float(input_prob.get(mode, 0.0)) and mode in available:
            return mode
    return "synth"
