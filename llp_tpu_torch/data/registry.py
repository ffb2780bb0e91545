"""Dataset registry: name -> (features, undirected edge list).

The subset of ``llp_tpu/data/registry.py`` that serving needs, in the same
order of preference:

1. ``synthetic:sbm:<n>:<k>:<deg>[:seed[:dim[:binary|gauss]]]`` and
   ``synthetic:ba:<n>:<m>[:seed]`` specs;
2. ``<root>/<name>.npz``, the interchange file (:mod:`llp_tpu_torch.data.io`);
3. a seeded synthetic stand-in with the real dataset's (N, D, avg-degree)
   shape, byte-identical to the JAX package's stand-in for the same name.

The raw Planetoid, GNN-benchmark and OGB parsers are not ported yet.  Where
their files are present the JAX package would load the real data, so this
registry raises instead of silently serving a stand-in in their place.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass

import numpy as np

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

# Raw files the JAX registry parses before it falls back to a stand-in.
_RAW_MARKERS = {
    "cora": ["Cora/raw/ind.cora.allx", "cora/raw/ind.cora.allx", "ind.cora.allx"],
    "citeseer": ["Citeseer/raw/ind.citeseer.allx", "citeseer/raw/ind.citeseer.allx",
                 "ind.citeseer.allx"],
    "pubmed": ["Pubmed/raw/ind.pubmed.allx", "pubmed/raw/ind.pubmed.allx",
               "ind.pubmed.allx"],
    "coauthor-cs": ["ms_academic_cs.npz", "coauthor-cs/ms_academic_cs.npz",
                    "coauthor-cs/raw/ms_academic_cs.npz", "CS/raw/ms_academic_cs.npz"],
    "coauthor-physics": ["ms_academic_phy.npz", "coauthor-physics/ms_academic_phy.npz",
                         "coauthor-physics/raw/ms_academic_phy.npz",
                         "Physics/raw/ms_academic_phy.npz"],
    "amazon-computers": ["amazon_electronics_computers.npz",
                         "amazon-computers/amazon_electronics_computers.npz",
                         "amazon-computers/raw/amazon_electronics_computers.npz",
                         "Computers/raw/amazon_electronics_computers.npz"],
    "amazon-photos": ["amazon_electronics_photo.npz",
                      "amazon-photos/amazon_electronics_photo.npz",
                      "amazon-photos/raw/amazon_electronics_photo.npz",
                      "Photo/raw/amazon_electronics_photo.npz"],
    "collab": ["ogbl_collab/raw/edge.csv.gz", "collab/raw/edge.csv.gz", "edge.csv.gz"],
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
        from llp_tpu_torch.data.io import unpack_dataset_npz

        with np.load(npz_path) as z:
            d = unpack_dataset_npz(z)
        return Dataset(
            name, d["x"], d["edge_index"], edge_weight=d["edge_weight"],
            split=d["split"], split_name=d["split_name"],
        )

    for rel in _RAW_MARKERS.get(name, ()):
        if os.path.exists(os.path.join(root, rel)):
            raise NotImplementedError(
                f"{os.path.join(root, rel)} is a raw {name} download; the port "
                f"reads only {name}.npz so far (ROADMAP Queue A: raw dataset "
                f"parsers). Export it once with "
                f"llp_tpu.data.io.save_dataset_npz."
            )

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
