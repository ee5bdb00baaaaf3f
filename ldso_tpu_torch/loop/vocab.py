"""Bag-of-words vocabulary for loop detection (DBoW3 replacement).

Counterpart of ldso_tpu/loop/vocab.py. The reference vendors DBoW3
(thirdparty/DBoW3) and loads a pre-trained ORB vocabulary at startup
(run_dso_tum_mono.cc:28,318). This module provides, with the JAX module's
numpy host code:

  * `Vocabulary.train(...)`: hierarchical k-medoids over binary descriptors
    (k-ary tree, majority-bit centroids), so a run can bootstrap its own
    vocabulary when no .dbow3 file is given;
  * the DBoW3 binary format (`load_binary` / `save_binary`, QuickLZ chunks
    through loop/qlz.py) and the DBoW2/DBoW3 text format (`load_text`);
  * the descriptor -> word transform (tree descent by Hamming argmin) in
    the native library (ldso_tpu_torch/native.py); `_transform_batch` is
    its torch twin on any device, (N, k) popcounts per level;
  * TF-IDF weighted, L1-normalized BoW vectors and the DBoW3 L1 score
    s(v, w) = 1 - 0.5 * |v - w|_1   (ScoringObject.cpp semantics).

The inverted-index database lives in `loop/database.py`.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ldso_tpu_torch import native


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(N, 256) {0,1} -> (N, 8) uint32 little-endian per word."""
    b = bits.reshape(-1, 8, 32).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)[None, None, :]).sum(-1,
                                                                    dtype=np.uint32)


def _unpack_bits(words: np.ndarray) -> np.ndarray:
    w = words[..., None] >> np.arange(32, dtype=np.uint32)[None, None, :]
    return (w & 1).reshape(words.shape[0], 256).astype(np.uint8)


def _majority_centroid(bits: np.ndarray) -> np.ndarray:
    """Bitwise-majority mean descriptor (DescManip::meanValue)."""
    return (bits.mean(axis=0) >= 0.5).astype(np.uint8)


def _hamming_np(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    return (a_bits[:, None, :] != b_bits[None, :, :]).sum(-1)


class Vocabulary:
    """k-ary vocabulary tree over 256-bit descriptors."""

    def __init__(self, k: int, L: int, node_desc: np.ndarray,
                 children: np.ndarray, is_leaf: np.ndarray,
                 word_id: np.ndarray, word_weight: np.ndarray):
        self.k = k
        self.L = L
        self.node_desc = node_desc          # (M, 8) uint32
        self.children = children            # (M, k) int32, -1 pad
        self.is_leaf = is_leaf              # (M,) bool
        self.word_id = word_id              # (M,) int32, -1 for non-leaves
        self.word_weight = word_weight      # (n_words,) float32 (idf)
        self.n_words = int(word_weight.shape[0])

    # ------------------------------------------------------------- training
    @staticmethod
    def train(descriptors: np.ndarray, k: int = 9, L: int = 3,
              seed: int = 0, max_iters: int = 8) -> "Vocabulary":
        """descriptors: (N, 8) uint32. Hierarchical binary k-medoids."""
        rng = np.random.RandomState(seed)
        bits = _unpack_bits(descriptors)

        nodes_desc: List[np.ndarray] = [np.zeros(256, np.uint8)]  # root
        children: List[List[int]] = [[]]
        is_leaf: List[bool] = [False]

        def cluster(idx: np.ndarray, level: int, parent: int):
            data = bits[idx]
            if level == L or len(idx) <= k:
                # each remaining descriptor cluster becomes one leaf
                node = len(nodes_desc)
                nodes_desc.append(_majority_centroid(data))
                children.append([])
                is_leaf.append(True)
                children[parent].append(node)
                return
            # k-means with majority centroids
            sel = rng.choice(len(idx), size=k, replace=False)
            cents = data[sel].copy()
            for _ in range(max_iters):
                d = _hamming_np(data, cents)
                assign = d.argmin(1)
                new = []
                for c in range(k):
                    m = assign == c
                    new.append(_majority_centroid(data[m]) if m.any()
                               else cents[c])
                new = np.stack(new)
                if (new == cents).all():
                    break
                cents = new
            d = _hamming_np(data, cents)
            assign = d.argmin(1)
            for c in range(k):
                m = assign == c
                if not m.any():
                    continue
                node = len(nodes_desc)
                nodes_desc.append(cents[c])
                children.append([])
                is_leaf.append(False)
                children[parent].append(node)
                cluster(idx[m], level + 1, node)
                if not children[node]:      # ended as leaf
                    is_leaf[node] = True

        cluster(np.arange(len(bits)), 0, 0)

        M = len(nodes_desc)
        ch = np.full((M, k), -1, np.int32)
        for i, c in enumerate(children):
            ch[i, :len(c)] = c[:k]
        leaf = np.asarray(is_leaf)
        wid = np.full(M, -1, np.int32)
        leaves = np.nonzero(leaf)[0]
        wid[leaves] = np.arange(len(leaves))
        desc = _pack_bits(np.stack(nodes_desc).reshape(M, 256))
        # uniform idf until set_weights_from_corpus
        ww = np.ones(len(leaves), np.float32)
        return Vocabulary(k, L, desc, ch, leaf, wid, ww)

    def set_idf_weights(self, corpus_words: List[np.ndarray]):
        """TF-IDF weighting from a corpus of word-id arrays."""
        n_docs = max(len(corpus_words), 1)
        counts = np.zeros(self.n_words, np.float64)
        for ws in corpus_words:
            counts[np.unique(ws)] += 1
        self.word_weight = np.log(n_docs / np.maximum(counts, 1)).astype(np.float32)
        self.word_weight = np.maximum(self.word_weight, 1e-3)

    # ------------------------------------------------------------- file I/O
    MAGIC = 88877711233        # DBoW3 binary signature (Vocabulary.cpp:1146)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        """Sniff the format: DBoW3 binary (.dbow3) by magic, else text."""
        with open(path, "rb") as f:
            sig = f.read(8)
        if len(sig) == 8 and int.from_bytes(sig, "little") == Vocabulary.MAGIC:
            return Vocabulary.load_binary(path)
        return Vocabulary.load_text(path)

    @staticmethod
    def load_binary(path: str) -> "Vocabulary":
        """DBoW3 binary format (Vocabulary::fromStream,
        thirdparty/DBoW3/src/Vocabulary.cpp:1299-1371):

          u64 magic | u8 compressed | u32 nnodes | payload
          payload   = i32 k, L, scoring, weighting
                      (nnodes-1) x [u32 node_id, u32 parent_id, f64 weight,
                                    i32 cols, i32 rows, i32 cvtype,
                                    cols bytes descriptor]
                      u32 n_words, n_words x [u32 word_id, u32 node_id]
          compressed payloads are QuickLZ-L1 chunks of <= 10000 bytes, each
          prefixed stream carrying its own sizes (Vocabulary.cpp:1196-1216).
        """
        import struct
        from ldso_tpu_torch.loop import qlz

        with open(path, "rb") as f:
            raw = f.read()
        sig, = struct.unpack_from("<Q", raw, 0)
        if sig != Vocabulary.MAGIC:
            raise ValueError(f"{path}: not a DBoW3 binary vocabulary")
        compressed = raw[8] != 0
        nnodes, = struct.unpack_from("<I", raw, 9)
        if nnodes == 0:
            raise ValueError(f"{path}: empty vocabulary")
        if compressed:
            nchunks, = struct.unpack_from("<I", raw, 13)
            off = 17
            parts = []
            for _ in range(nchunks):
                csize = qlz.size_compressed(raw, off)
                parts.append(qlz.decompress(raw, off))
                off += csize
            buf = b"".join(parts)
        else:
            buf = raw[13:]

        off = 0
        k, L, _scoring, _weighting = struct.unpack_from("<iiii", buf, off)
        off += 16
        desc_b = np.zeros((nnodes, 32), np.uint8)
        parent = np.full(nnodes, -1, np.int64)
        weight = np.zeros(nnodes, np.float64)
        order = []                      # child ids in file (=DFS) order
        for _ in range(nnodes - 1):
            nid, pid = struct.unpack_from("<II", buf, off)
            w, = struct.unpack_from("<d", buf, off + 8)
            cols, _rows, cvtype = struct.unpack_from("<iii", buf, off + 16)
            off += 28
            if cvtype != 0 or cols != 32:
                raise ValueError(f"{path}: only 256-bit CV_8U descriptors "
                                 f"supported (got type={cvtype}, cols={cols})")
            desc_b[nid] = np.frombuffer(buf, np.uint8, 32, off)
            off += 32
            parent[nid] = pid
            weight[nid] = w
            order.append(nid)
        children = np.full((nnodes, k), -1, np.int32)
        fill = np.zeros(nnodes, np.int32)
        for nid in order:               # file order preserves child order
            p = parent[nid]
            if fill[p] < k:
                children[p, fill[p]] = nid
                fill[p] += 1
        n_words, = struct.unpack_from("<I", buf, off)
        off += 4
        wid = np.full(nnodes, -1, np.int32)
        ww = np.zeros(n_words, np.float32)
        for _ in range(n_words):
            w_id, nid = struct.unpack_from("<II", buf, off)
            off += 8
            wid[nid] = w_id
            ww[w_id] = weight[nid]
        leaf = wid >= 0
        words = _pack_bits(
            np.unpackbits(desc_b, axis=1, bitorder="little").reshape(nnodes, 256))
        return Vocabulary(k, L, words, children, leaf, wid, ww)

    def save_binary(self, path: str):
        """Write the DBoW3 binary layout (uncompressed mode — the flag byte
        the reference reader already honors, Vocabulary.cpp:1314)."""
        import struct

        M = self.node_desc.shape[0]
        desc_b = np.packbits(
            _unpack_bits(self.node_desc).reshape(M, 256), axis=1,
            bitorder="little")
        weight = np.zeros(M, np.float64)
        leaves = np.nonzero(self.is_leaf)[0]
        weight[leaves] = self.word_weight[self.word_id[leaves]]

        out = [struct.pack("<iiii", self.k, self.L, 0, 0)]   # L1, TF_IDF
        stack = [0]
        nnodes = 1
        while stack:                    # DFS matching toStream's traversal
            pid = stack.pop()
            for c in self.children[pid]:
                if c < 0:
                    continue
                out.append(struct.pack("<IId", int(c), int(pid),
                                       float(weight[c])))
                out.append(struct.pack("<iii", 32, 1, 0))
                out.append(desc_b[c].tobytes())
                nnodes += 1
                if not self.is_leaf[c]:
                    stack.append(int(c))
        out.append(struct.pack("<I", self.n_words))
        for nid in leaves:
            out.append(struct.pack("<II", int(self.word_id[nid]), int(nid)))
        with open(path, "wb") as f:
            f.write(struct.pack("<QBI", Vocabulary.MAGIC, 0, nnodes))
            f.write(b"".join(out))

    @staticmethod
    def load_text(path: str) -> "Vocabulary":
        """DBoW2/DBoW3 text format: 'k L scoring weighting' then per node:
        parent_id is_leaf d0..d31 weight."""
        with open(path) as f:
            header = f.readline().split()
            k, L = int(header[0]), int(header[1])
            rows = []
            for line in f:
                t = line.split()
                if len(t) < 35:
                    continue
                rows.append((int(t[0]), int(t[1]),
                             np.array([int(x) for x in t[2:34]], np.uint8),
                             float(t[34])))
        M = len(rows) + 1
        desc_b = np.zeros((M, 32), np.uint8)
        parent = np.full(M, -1, np.int32)
        leaf = np.zeros(M, bool)
        weight = np.zeros(M, np.float32)
        for i, (p, lf, d, w) in enumerate(rows):
            n = i + 1
            parent[n] = p
            leaf[n] = bool(lf)
            desc_b[n] = d
            weight[n] = w
        children = np.full((M, k), -1, np.int32)
        fill = np.zeros(M, np.int32)
        for n in range(1, M):
            p = parent[n]
            if 0 <= p < M and fill[p] < k:
                children[p, fill[p]] = n
                fill[p] += 1
        wid = np.full(M, -1, np.int32)
        leaves = np.nonzero(leaf)[0]
        wid[leaves] = np.arange(len(leaves))
        words = _pack_bits(
            np.unpackbits(desc_b, axis=1, bitorder="little").reshape(M, 256))
        return Vocabulary(k, L, words, children, leaf, wid,
                          weight[leaves].astype(np.float32))

    # ------------------------------------------------------------ transform
    def device_tables(self, device="cpu"):
        """(node_desc int64, children int64, word_id int64) on `device`
        for `_transform_batch`."""
        return (torch.from_numpy(self.node_desc.astype(np.int64)).to(device),
                torch.from_numpy(self.children.astype(np.int64)).to(device),
                torch.from_numpy(self.word_id.astype(np.int64)).to(device))

    def transform(self, desc, valid) -> np.ndarray:
        """(N, 8) uint32 -> word ids (N,), -1 for invalid, through the
        native library (raises when it cannot be built)."""
        desc_np = np.asarray(desc, np.uint32)
        valid_np = np.asarray(valid, bool)
        out = native.bow_transform(desc_np, self.node_desc, self.children,
                                   self.word_id, self.k, self.L)
        return np.where(valid_np, out, -1)

    # ------------------------------------------------------- feature vector
    def _node_table(self, levelsup: int) -> np.ndarray:
        """word id -> ancestor node id at depth (L - levelsup) from the root
        (DBoW3 Vocabulary::transform's nid_level; root when <= 0). Cached."""
        cache = getattr(self, "_node_tabs", None)
        if cache is None:
            cache = self._node_tabs = {}
        tab = cache.get(levelsup)
        if tab is not None:
            return tab
        M = len(self.word_id)
        parent = np.full(M, -1, np.int64)
        ch = self.children
        rows, cols = np.nonzero(ch >= 0)
        parent[ch[rows, cols]] = rows
        # depths: iterate to fixpoint (no node-ordering assumption)
        depth = np.full(M, -1, np.int64)
        depth[0] = 0
        for _ in range(self.L + 2):
            has_p = parent >= 0
            d_new = np.where(has_p & (depth[np.maximum(parent, 0)] >= 0),
                             depth[np.maximum(parent, 0)] + 1, depth)
            if (d_new == depth).all():
                break
            depth = d_new
        nid_level = max(self.L - levelsup, 0)
        node = np.arange(M, dtype=np.int64)
        for _ in range(self.L + 1):
            up = depth[node] > nid_level
            node = np.where(up & (parent[node] >= 0), parent[node], node)
        leaves = np.nonzero(self.is_leaf)[0]
        tab = np.full(self.n_words, 0, np.int32)
        tab[self.word_id[leaves]] = node[leaves].astype(np.int32)
        cache[levelsup] = tab
        return tab

    def node_ids(self, word_ids: np.ndarray, levelsup: int = 4) -> np.ndarray:
        """DBoW3 FeatureVector bucketing (Frame::ComputeBoW passes
        levelsup=4, Frame.cc:101): per feature, the vocabulary-tree node
        `levelsup` levels above the leaves. -1 stays -1."""
        word_ids = np.asarray(word_ids, np.int64)
        tab = self._node_table(levelsup)
        out = np.full(len(word_ids), -1, np.int32)
        ok = (word_ids >= 0) & (word_ids < self.n_words)
        out[ok] = tab[word_ids[ok]]
        return out

    def bow_vector(self, word_ids: np.ndarray) -> Dict[int, float]:
        """TF-IDF weighted, L1-normalized (DBoW3 WeightingType::TF_IDF)."""
        v: Dict[int, float] = {}
        for w in word_ids:
            if w < 0:
                continue
            wt = float(self.word_weight[w])
            if wt <= 0:
                continue
            v[int(w)] = v.get(int(w), 0.0) + wt
        s = sum(v.values())
        if s > 0:
            v = {k: val / s for k, val in v.items()}
        return v

    @staticmethod
    def score(v1: Dict[int, float], v2: Dict[int, float]) -> float:
        """DBoW3 L1 score: 1 - 0.5 |v1 - v2|_1  in [0, 1]."""
        s = 0.0
        for w, a in v1.items():
            b = v2.get(w)
            if b is not None:
                s += abs(a) + abs(b) - abs(a - b)
        return 0.5 * s


def _transform_batch(desc, node_desc, children, word_id, L: int,
                     k: int) -> torch.Tensor:
    """Descend the tree: per level one (N, k) Hamming argmin, ties to the
    lowest child as jnp.argmin. desc (N, 8) int64 words; the tables from
    Vocabulary.device_tables."""
    from ldso_tpu_torch.frontend.detector import _popcount32
    cur = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    for _ in range(L + 1):
        kids = children[cur]                                # (N, k)
        kd = node_desc[torch.clamp(kids, min=0)]            # (N, k, 8)
        d = torch.sum(_popcount32(torch.bitwise_xor(kd, desc[:, None, :])),
                      dim=-1)
        d = torch.where(kids >= 0, d, torch.full_like(d, 10 ** 6))
        dmin = torch.min(d, dim=-1, keepdim=True)[0]
        cols = torch.arange(k, device=desc.device)
        best = torch.min(torch.where(d == dmin, cols, torch.full_like(cols, k)),
                         dim=-1)[0]
        nxt = torch.gather(kids, 1, best[:, None])[:, 0]
        # stay put at a leaf / a node without children
        cur = torch.where(torch.any(kids >= 0, dim=-1), nxt, cur)
    return word_id[cur]
