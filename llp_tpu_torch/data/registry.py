"""Dataset registry: name -> (features, undirected edge list).

The port of ``llp_tpu/data/registry.py``, in the same order of preference:

1. ``synthetic:sbm:<n>:<k>:<deg>[:seed[:dim[:binary|gauss]]]`` and
   ``synthetic:ba:<n>:<m>[:seed]`` specs;
2. ``<root>/<name>.npz``, the interchange file (:mod:`llp_tpu_torch.data.io`);
3. the raw Planetoid files (``ind.<name>.{allx,tx,graph,test.index}``, for
   cora, citeseer and pubmed) under ``<root>/<Name>/raw``,
   ``<root>/<name>/raw`` or ``<root>``;
4. a GNN-benchmark ``.npz`` (``ms_academic_cs.npz`` and the other files
   PyG's Coauthor and Amazon classes download) under ``<root>``,
   ``<root>/<name>[/raw]`` or ``<root>/<PyG name>/raw``;
5. an OGB ``ogbl_collab`` download (``edge.csv.gz`` + ``node-feat.csv.gz``,
   ``edge_weight.csv.gz`` and the shipped ``split/<scheme>/*.pt``), the only
   source of real edge weights, parsed once and cached in
   ``<root>/<name>_parsed.npz`` under a fingerprint of the download;
6. a seeded synthetic stand-in with the real dataset's (N, D, avg-degree)
   shape, byte-identical to the JAX package's stand-in for the same name.

Both raw parsers give the arrays the JAX package's give on the same files:
an undirected edge list, both directions, sorted and unique, with no
self-loops.  They read the files without torch_geometric; scipy, which
holds the sparse matrices inside them, is imported by the parsers only.
"""

from __future__ import annotations

import gzip
import os
import pickle
import zipfile
import zlib
from dataclasses import dataclass

import numpy as np

from llp_tpu_torch.data.io import save_dataset_npz, unpack_dataset_npz
from llp_tpu_torch.data.synthetic import ba_graph, community_features, sbm_graph

# (num_nodes, feature_dim, avg_degree, feature_kind, communities) of the real
# datasets — used to shape synthetic stand-ins.
_REAL_SHAPES = {
    "cora": (2708, 1433, 3.9, "binary", 7),
    "citeseer": (3327, 3703, 2.7, "binary", 6),
    "pubmed": (19717, 500, 4.5, "binary", 3),
    "coauthor-cs": (18333, 6805, 8.9, "binary", 15),
    "coauthor-physics": (34493, 8415, 14.4, "binary", 5),
    "amazon-computers": (13752, 767, 35.8, "binary", 10),
    "amazon-photos": (7650, 745, 31.1, "binary", 8),
    "collab": (235868, 128, 8.2, "gauss", 64),
}

@dataclass
class Dataset:
    name: str
    x: np.ndarray            # (N, D) float32
    edge_index: np.ndarray   # (2, E) int64, undirected (both directions)
    synthetic: bool = False
    edge_weight: np.ndarray | None = None  # (E,) float32, aligned with edge_index
    split: dict | None = None              # official split shipped in the npz
    split_name: str = ""

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])


def get_dataset(root: str, name: str) -> Dataset:
    if name.startswith("synthetic:"):
        return _synthetic_by_spec(name)

    npz_path = os.path.join(root, f"{name}.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path) as z:
            d = unpack_dataset_npz(z)
        return Dataset(
            name, d["x"], d["edge_index"], edge_weight=d["edge_weight"],
            split=d["split"], split_name=d["split_name"],
        )

    planetoid = _try_planetoid(root, name)
    if planetoid is not None:
        return planetoid

    gnn_bench = _try_gnn_benchmark(root, name)
    if gnn_bench is not None:
        return gnn_bench

    ogb = _try_ogb_collab(root, name)
    if ogb is not None:
        return ogb

    if name in _REAL_SHAPES:
        return _synthetic_standin(name)

    raise ValueError(
        f"unknown dataset {name!r}; expected one of {sorted(_REAL_SHAPES)}, a "
        f"synthetic: spec, or a {name}.npz under {root!r}"
    )


def _synthetic_by_spec(spec: str) -> Dataset:
    parts = spec.split(":")
    kind = parts[1]
    if kind == "sbm":
        n, k, deg = int(parts[2]), int(parts[3]), float(parts[4])
        seed = int(parts[5]) if len(parts) > 5 else 0
        dim = int(parts[6]) if len(parts) > 6 else min(max(64, n // 16), 1433)
        feat_kind = parts[7] if len(parts) > 7 else "binary"
        ei, comm = sbm_graph(n, k, deg, seed=seed)
        x = community_features(comm, dim, kind=feat_kind, seed=seed)
        return Dataset(spec, x, ei, synthetic=True)
    if kind == "ba":
        n, m = int(parts[2]), int(parts[3])
        seed = int(parts[4]) if len(parts) > 4 else 0
        ei = ba_graph(n, m, seed=seed)
        rng = np.random.default_rng(seed)
        comm = rng.integers(0, 8, size=n)
        x = community_features(comm, 128, kind="gauss", seed=seed)
        return Dataset(spec, x, ei, synthetic=True)
    raise ValueError(f"unknown synthetic spec {spec!r}")


def _synthetic_standin(name: str) -> Dataset:
    n, d, deg, feat_kind, k = _REAL_SHAPES[name]
    # crc32, not hash(): stable across processes (hash() is salted).
    seed = zlib.crc32(name.encode()) % (2**31)
    ei, comm = sbm_graph(n, k, deg, homophily=0.88, seed=seed)
    x = community_features(comm, d, kind=feat_kind, seed=seed)
    return Dataset(name, x, ei, synthetic=True)


def _symmetrize_dedup(ei: np.ndarray, n: int) -> np.ndarray:
    """Both directions, unique, self-loops removed; (2, E) int64."""
    keys = np.unique(np.concatenate([ei[0] * n + ei[1], ei[1] * n + ei[0]]))
    ei = np.stack([keys // n, keys % n])
    return ei[:, ei[0] != ei[1]]


def _coalesce_undirected(ei: np.ndarray, n: int, weight: np.ndarray):
    """Both directions, duplicates coalesced by summing their weights,
    self-loops removed (``SparseTensor.coalesce`` on a weighted multigraph:
    collab's raw edge list repeats a pair once per year of collaboration).
    Returns ``(edge_index (2, E), weight (E,) float32)``."""
    both = np.concatenate([ei, ei[::-1]], axis=1)
    w2 = np.concatenate([weight, weight]).astype(np.float64)
    keys, inv = np.unique(both[0] * n + both[1], return_inverse=True)
    w = np.bincount(inv, weights=w2, minlength=keys.shape[0])
    out = np.stack([keys // n, keys % n])
    keep = out[0] != out[1]
    return out[:, keep], w[keep].astype(np.float32)


def _try_ogb_collab(root: str, name: str):
    """An untouched OGB ``ogbl_collab`` download (the reference loads collab
    through ``PygLinkPropPredDataset('ogbl-collab')``), or None.  The parse is
    cached in ``<root>/<name>_parsed.npz`` under a fingerprint of the raw
    files (name, size, mtime), so a fresh download invalidates it."""
    if name not in ("collab", "ogbl-collab"):
        return None
    for base in (os.path.join(root, "ogbl_collab", "raw"),
                 os.path.join(root, "collab", "raw"), root):
        if (os.path.exists(os.path.join(base, "edge.csv.gz"))
                and os.path.exists(os.path.join(base, "node-feat.csv.gz"))):
            fp = _raw_fingerprint(base)
            cache = os.path.join(root, f"{name}_parsed.npz")
            ds = _load_parsed_cache(cache, name, fp)
            if ds is not None:
                return ds
            ds = _parse_ogb_collab(base, name)
            _save_parsed_cache(cache, ds, fp)
            return ds
    return None


def _raw_fingerprint(raw_base: str) -> int:
    """crc32 over the download's raw and split files (relative path, size,
    mtime)."""
    h = 0
    roots = [raw_base, os.path.join(os.path.dirname(os.path.abspath(raw_base)), "split")]
    for r in roots:
        for dirpath, _, files in sorted(os.walk(r)):
            for f in sorted(files):
                p = os.path.join(dirpath, f)
                st = os.stat(p)
                h = zlib.crc32(f"{os.path.relpath(p, r)}:{st.st_size}:{st.st_mtime_ns}".encode(), h)
    return int(h)


def _load_parsed_cache(cache: str, name: str, fp: int):
    """The cached parse, or None when it is missing, stale or unreadable."""
    if not os.path.exists(cache):
        return None
    try:
        with np.load(cache) as z:
            if "raw_fingerprint" not in z or int(z["raw_fingerprint"]) != fp:
                return None  # stale: the download changed
            d = unpack_dataset_npz(z)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile, zlib.error):
        return None  # unreadable: parse afresh
    return Dataset(name, d["x"], d["edge_index"], edge_weight=d["edge_weight"],
                   split=d["split"], split_name=d["split_name"])


def _save_parsed_cache(cache: str, ds: Dataset, fp: int) -> None:
    try:
        save_dataset_npz(cache, ds.x, ds.edge_index, edge_weight=ds.edge_weight,
                         split=ds.split, split_name=ds.split_name,
                         extra={"raw_fingerprint": np.asarray(fp, np.int64)})
    except OSError:
        pass  # a read-only dataset directory: the cache is best-effort


def _parse_ogb_collab(base: str, name: str) -> Dataset:
    with gzip.open(os.path.join(base, "node-feat.csv.gz"), "rt") as f:
        x = np.loadtxt(f, delimiter=",", dtype=np.float32, ndmin=2)
    with gzip.open(os.path.join(base, "edge.csv.gz"), "rt") as f:
        ei = np.loadtxt(f, delimiter=",", dtype=np.int64, ndmin=2).T
    # edge_weight.csv.gz comes in the same download: co-authorship counts
    # (the reference loads them as data.edge_weight, src/main.py:310).
    w = None
    w_path = os.path.join(base, "edge_weight.csv.gz")
    if os.path.exists(w_path):
        with gzip.open(w_path, "rt") as f:
            w = np.loadtxt(f, delimiter=",", dtype=np.float32).reshape(-1)
        if w.shape[0] != ei.shape[1]:
            raise ValueError(f"edge_weight.csv.gz has {w.shape[0]} rows for "
                             f"{ei.shape[1]} edges")
    if w is None:
        ei_u, w_u = _symmetrize_dedup(ei, x.shape[0]), None
    else:
        ei_u, w_u = _coalesce_undirected(ei, x.shape[0], w)
    # The official time split ships as split/time/{train,valid,test}.pt
    # beside raw/ (the reference's dataset.get_edge_split(), src/main.py:313).
    split, split_name = _load_ogb_split(base)
    return Dataset(name, x, ei_u, edge_weight=w_u, split=split, split_name=split_name)


def _load_ogb_split(raw_base: str):
    """The OGB split files (torch-saved dicts of arrays or tensors) of the
    first ``split/<scheme>/`` directory beside ``raw/`` (or inside it) that
    holds all three parts: ``(split, "ogb:<scheme>")`` with int64 (M, 2)
    ``edge``/``edge_neg`` and float32 ``weight``, or ``(None, "")``."""
    import torch

    candidates = []
    parent = os.path.dirname(os.path.abspath(raw_base))
    for holder in (parent, raw_base):
        split_root = os.path.join(holder, "split")
        if os.path.isdir(split_root):
            for scheme in sorted(os.listdir(split_root)):
                candidates.append((os.path.join(split_root, scheme), scheme))
    for sdir, scheme in candidates:
        paths = {p: os.path.join(sdir, f"{p}.pt") for p in ("train", "valid", "test")}
        if not all(os.path.exists(p) for p in paths.values()):
            continue
        out = {}
        for part, path in paths.items():
            # The split files hold numpy arrays, which weights_only refuses.
            blob = torch.load(path, map_location="cpu", weights_only=False)
            if not isinstance(blob, dict):
                raise ValueError(f"OGB split file {path} is not a dict "
                                 f"(got {type(blob).__name__})")
            d = {}
            for k, v in blob.items():
                a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                if k in ("edge", "edge_neg"):
                    a = a.astype(np.int64)
                    if a.ndim != 2 or a.shape[1] != 2:
                        raise ValueError(f"{path}: {k} must be (M, 2), got {a.shape}")
                elif k == "weight":
                    a = a.astype(np.float32).reshape(-1)
                d[k] = a
            if "edge" not in d:
                raise ValueError(f"{path} has no 'edge' key")
            out[part] = d
        return out, f"ogb:{scheme}"
    return None, ""


# The raw files PyG's Coauthor and Amazon classes download (the reference
# loads these names through those classes, src/utils.py:35-43), and PyG's
# folder for each.
_GNN_BENCHMARK_FILES = {
    "coauthor-cs": ("ms_academic_cs.npz", "CS"),
    "coauthor-physics": ("ms_academic_phy.npz", "Physics"),
    "amazon-computers": ("amazon_electronics_computers.npz", "Computers"),
    "amazon-photos": ("amazon_electronics_photo.npz", "Photo"),
}


def _try_gnn_benchmark(root: str, name: str):
    """A GNN-benchmark ``.npz`` (CSR adjacency, CSR or dense attributes) of
    ``name``, parsed, or None."""
    if name not in _GNN_BENCHMARK_FILES:
        return None
    fname, pyg_dir = _GNN_BENCHMARK_FILES[name]
    for base in (root, os.path.join(root, name), os.path.join(root, name, "raw"),
                 os.path.join(root, pyg_dir, "raw")):
        path = os.path.join(base, fname)
        if os.path.exists(path):
            return _parse_gnn_benchmark(path, name)
    return None


def _parse_gnn_benchmark(path: str, name: str) -> Dataset:
    import scipy.sparse as sp

    # The files hold plain arrays: a download is never allowed to unpickle.
    with np.load(path, allow_pickle=False) as z:
        adj = sp.csr_matrix((z["adj_data"], z["adj_indices"], z["adj_indptr"]),
                            shape=tuple(z["adj_shape"])).tocoo()
        if "attr_data" in z:
            x = np.asarray(sp.csr_matrix((z["attr_data"], z["attr_indices"],
                                          z["attr_indptr"]),
                                         shape=tuple(z["attr_shape"])).todense(),
                           dtype=np.float32)
        else:
            x = np.asarray(z["attr_matrix"], dtype=np.float32)
    ei = np.stack([adj.row.astype(np.int64), adj.col.astype(np.int64)])
    # PyG loads these graphs undirected with the self-loops removed
    # (torch_geometric.io.npz).
    return Dataset(name, x, _symmetrize_dedup(ei, x.shape[0]))


_PLANETOID_FOLDERS = {"cora": "Cora", "citeseer": "Citeseer", "pubmed": "Pubmed"}


def _try_planetoid(root: str, name: str):
    """The raw Planetoid files (``ind.<name>.{x,tx,allx,graph,test.index}``)
    of ``name``, parsed, or None."""
    if name not in _PLANETOID_FOLDERS:
        return None
    for base in (os.path.join(root, _PLANETOID_FOLDERS[name], "raw"),
                 os.path.join(root, name, "raw"), root):
        if os.path.exists(os.path.join(base, f"ind.{name}.allx")):
            return _parse_planetoid(base, name)
    return None


def _parse_planetoid(base: str, name: str) -> Dataset:
    """Features: ``allx`` then ``tx``, the test rows put back at their ids;
    edges: the ``graph`` dict of adjacency lists, self-loops dropped, made
    undirected and unique."""
    import scipy.sparse as sp

    def load_pickle(suffix):
        # Python 2 pickles of scipy matrices and a defaultdict
        with open(os.path.join(base, f"ind.{name}.{suffix}"), "rb") as f:
            return pickle.load(f, encoding="latin1")

    allx, tx, graph = load_pickle("allx"), load_pickle("tx"), load_pickle("graph")
    test_idx = np.loadtxt(os.path.join(base, f"ind.{name}.test.index"), dtype=np.int64)
    test_idx_range = np.sort(test_idx)
    if name == "citeseer":
        # citeseer's test ids leave gaps (isolated nodes): zero rows fill them
        full = np.arange(test_idx_range.min(), test_idx_range.max() + 1)
        tx_ext = sp.lil_matrix((len(full), allx.shape[1]))
        tx_ext[test_idx_range - test_idx_range.min(), :] = tx
        tx = tx_ext
    x = sp.vstack([allx, tx]).tolil()
    x[test_idx, :] = x[test_idx_range, :]
    x = np.asarray(x.todense(), dtype=np.float32)
    edges = [(u, v) for u, nbrs in graph.items() for v in nbrs if u != v]
    ei = np.array(edges, dtype=np.int64).T
    n = x.shape[0]
    keys = np.unique(np.concatenate([ei[0] * n + ei[1], ei[1] * n + ei[0]]))
    return Dataset(name, x, np.stack([keys // n, keys % n]))
