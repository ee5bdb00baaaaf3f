"""Inverted-index keyframe database (DBoW3::Database replacement).

Counterpart of ldso_tpu/loop/database.py. LoopClosing adds keyframes' BoW
vectors and queries for the best-scoring candidates outside an exclusion
set (src/frontend/LoopClosing.cc:95-143). The index and the L1 scoring run
in the native library (ldso_tpu_torch/native.py); the Python dictionaries
keep the same records for inspection and for the pure-Python query below,
the reference the tests hold the native query against.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ldso_tpu_torch.loop.vocab import Vocabulary
from ldso_tpu_torch.native import NativeDatabase


class KeyframeDatabase:
    def __init__(self, vocab: Vocabulary):
        self.vocab = vocab
        self.inverted: Dict[int, List[int]] = {}     # word -> [kf_id]
        self.bows: Dict[int, Dict[int, float]] = {}  # kf_id -> bow vector
        self._native = NativeDatabase()

    def add(self, kf_id: int, bow: Dict[int, float]):
        self.bows[kf_id] = bow
        for w in bow:
            self.inverted.setdefault(w, []).append(kf_id)
        self._native.add(kf_id, np.fromiter(bow.keys(), np.int32, len(bow)),
                         np.fromiter(bow.values(), np.float32, len(bow)))

    def query(self, bow: Dict[int, float], exclude: set,
              max_results: int = 5) -> List[Tuple[int, float]]:
        """Best-scoring stored keyframes sharing at least one word, in
        descending score order."""
        return self._native.query(
            np.fromiter(bow.keys(), np.int32, len(bow)),
            np.fromiter(bow.values(), np.float32, len(bow)),
            np.fromiter(exclude, np.int32, len(exclude)), max_results)

    def query_python(self, bow: Dict[int, float], exclude: set,
                     max_results: int = 5) -> List[Tuple[int, float]]:
        """The same query in float64 Python (the JAX package's fallback)."""
        cands = set()
        for w in bow:
            cands.update(self.inverted.get(w, ()))
        cands -= exclude
        scored = [(kf, Vocabulary.score(bow, self.bows[kf])) for kf in cands]
        scored.sort(key=lambda t: -t[1])
        return scored[:max_results]
