"""Deterministic synthetic data pipeline with background prefetch.

Port of ``repro/data/pipeline.py``: the batch for step N is a pure
function of (seed, N) (numpy only, the reference's streams), which makes
checkpoint/restart exactly resumable without data-state snapshots;
``PrefetchIterator`` builds batch(step + 1) on a host thread while step
runs on the card.  Batches stay numpy; the model moves them to its device.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.models.config import ModelConfig

#: Stub modality-frontend feature width (audio frames / vision patches).
FRONTEND_DIM = 512


class SyntheticDataset:
    """Pure-function batches: batch(step) is reproducible by construction."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 1234):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = self._rng(step)
        b, s = self.batch, self.seq
        out = {}
        if cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (b, s, FRONTEND_DIM)).astype(np.float32)
            out["targets"] = rng.integers(0, cfg.vocab, (b, s),
                                          dtype=np.int32)
            # HuBERT-style masked prediction: ~8% mask starts, span 10.
            mask = rng.random((b, s)) < 0.08
            out["loss_mask"] = np.asarray(mask, np.int32)
        else:
            # Markov-ish token stream: correlated tokens so the loss is
            # learnable (quickstart demonstrates loss decreasing).
            base = rng.integers(0, cfg.vocab, (b, s + 1), dtype=np.int32)
            repeat = rng.random((b, s + 1)) < 0.5
            tokens = base.copy()
            for t in range(1, s + 1):
                tokens[:, t] = np.where(repeat[:, t], tokens[:, t - 1],
                                        base[:, t])
            out["tokens"] = tokens[:, :-1]
            out["targets"] = tokens[:, 1:].astype(np.int32)
            out["loss_mask"] = np.ones((b, s), np.int32)
        if cfg.mrope_sections:
            pos = np.arange(s, dtype=np.int32)[None, :, None]
            out["positions"] = np.broadcast_to(pos, (b, s, 3)).copy()
        else:
            out["positions"] = np.broadcast_to(
                np.arange(s, dtype=np.int32)[None], (b, s)).copy()
        if cfg.family == "vlm":
            out["vision_embeds"] = rng.standard_normal(
                (b, s, FRONTEND_DIM)).astype(np.float32)
            vm = np.zeros((b, s), bool)
            vm[:, : min(64, s // 4)] = True     # leading image tokens
            out["vision_mask"] = vm
        return out


class PrefetchIterator:
    """Builds batch(step+1) on a host thread while step runs on device.
    Yields (step, batch) from ``start_step`` on; ``close`` stops the
    thread."""

    def __init__(self, dataset: SyntheticDataset, start_step: int = 0,
                 depth: int = 2):
        self.dataset = dataset
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.dataset.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
