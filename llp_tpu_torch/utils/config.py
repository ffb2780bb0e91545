"""Experiment configurations (counterpart of ``llp_tpu/utils/config.py``):
the reference's flag surface as dataclasses with the same fields and
defaults, so a YAML file or a flag set means the same in both packages.

``finalize()`` applies the dataset-dependent overrides the reference
hardcodes: the selection metric (Hits@20; Hits@50 for collab), the hits
cutoffs, and dense or uniform negatives (uniform for collab only); it also
refuses a ``reorder`` other than ``none``, ``locality`` or ``rcm``.  Unlike
the JAX package it consults no device: the port has one SpMM route per
device, the segsum kernel on the card and its plain version on the CPU, so
``spmm_impl`` is ``auto`` or ``segsum`` and anything else is refused.

:class:`SplitConfig` holds the production splitter's ratios per dataset.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

from llp_tpu_torch.models.norms import VALID_NORM_TYPES
from llp_tpu_torch.utils.precision import resolve_dtype

SPMM_IMPLS = ("auto", "segsum")


def _hits_ks(dataset: str) -> Tuple[int, ...]:
    return (10, 50, 100) if dataset == "collab" else (10, 20, 30, 50)


@dataclass
class CommonConfig:
    log_steps: int = 50
    encoder: str = "sage"
    num_layers: int = 2
    hidden_channels: int = 256
    dropout: float = 0.5
    lr: float = 0.005
    epochs: int = 20000
    eval_steps: int = 1  # evaluate every N epochs; patience counts evaluations
    runs: int = 10
    dataset_dir: str = "./data"
    datasets: str = "cora"
    predictor: str = "mlp"  # 'inner' | 'mlp'
    norm_type: str = "none"  # 'none' | 'layer' | 'batch'
    patience: int = 100
    metric: str = "Hits@20"
    use_valedges_as_input: bool = False
    use_edge_weight: bool = False
    transductive: str = "transductive"  # 'transductive' | 'production'
    minibatch: bool = False
    seed_offset: int = 0  # teacher seeds run+0, student run+1 (reference)
    results_dir: str = "./results"
    spmm_impl: str = "auto"
    compute_dtype: str = "float32"  # fp32 masters; eval always fp32
    checkpoint_every: int = 0
    epochs_per_jit: int = 1
    resume: bool = False
    profile_dir: str = ""  # the second epoch and its eval traced to <dir>/trace.json ("" = off)
    num_devices: int = 1
    sharding: str = "dp"
    reorder: str = "none"
    reorder_parts: int = 0

    @property
    def hits_ks(self) -> Tuple[int, ...]:
        return _hits_ks(self.datasets)

    @property
    def neg_mode(self) -> str:
        return "uniform" if self.datasets == "collab" else "dense"

    def finalize(self):
        if self.norm_type not in VALID_NORM_TYPES:
            raise ValueError(
                f"norm_type={self.norm_type!r}; expected one of {VALID_NORM_TYPES}"
            )
        resolve_dtype(self.compute_dtype)
        if self.reorder not in ("none", "locality", "rcm"):
            raise ValueError(f"reorder must be 'none', 'locality' or 'rcm', got {self.reorder!r}")
        if self.use_edge_weight and self.transductive == "production":
            raise ValueError(
                "use_edge_weight is a transductive capability (the production "
                "splitter carries no edge weights)"
            )
        if self.spmm_impl not in SPMM_IMPLS:
            raise ValueError(
                f"spmm_impl={self.spmm_impl!r}: llp_tpu_torch has one SpMM route "
                f"per device (the segsum kernel on the card, its plain version on "
                f"the CPU); pass one of {SPMM_IMPLS}"
            )
        self.spmm_impl = "segsum"
        self.metric = "Hits@50" if self.datasets == "collab" else "Hits@20"
        return self

    @classmethod
    def from_yaml(cls, path: str, **overrides):
        import yaml  # only a YAML config needs it

        with open(path) as f:
            d = yaml.safe_load(f) or {}
        d.update(overrides)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass
class TeacherConfig(CommonConfig):
    batch_size: int = 64 * 1024
    runs: int = 5
    save_dir: str = "./saved"


@dataclass
class StudentConfig(CommonConfig):
    link_batch_size: int = 64 * 1024
    node_batch_size: int = 64 * 1024  # the coupling below sets the node batch
    true_label: float = 0.1
    kd_rm: float = 0.0
    kd_lm: float = 0.0
    llp_d: float = 1.0
    llp_r: float = 1.0
    # LLP_R pair chunk (0: every C(C,2) pair at once; > 0: chunks of this
    # many pairs under activation checkpointing, the same terms in
    # O(B·chunk) memory)
    llp_r_chunk: int = 0
    margin: float = 0.1
    rw_step: int = 3
    ns_rate: int = 1
    hops: int = 2
    ps_method: str = "nb"  # 'rw' | 'nb'
    save_dir: str = "./saved"

    def coupled_node_batch_size(self, num_nodes: int, num_train_edges: int) -> int:
        """The node batch that keeps the node loader from running dry before
        the link loader (reference ``main.py:335``)."""
        return max(
            1, int(num_nodes / (num_train_edges / min(self.link_batch_size, num_train_edges)))
        )


@dataclass
class SplitConfig:
    """The production splitter's ratios (reference ``train_teacher_gnn.py:352-365``):
    0.3 of the edges, of the nodes and of the training graph's edges held out
    for ``cora`` and ``citeseer``, 0.1 elsewhere."""

    test_ratio: float = 0.1
    val_node_ratio: float = 0.1
    val_ratio: float = 0.1
    old_old_extra_ratio: float = 0.1
    seed: int = 234

    @classmethod
    def for_dataset(cls, name: str) -> "SplitConfig":
        if name in ("cora", "citeseer"):
            return cls(test_ratio=0.3, val_node_ratio=0.3, val_ratio=0.3)
        return cls()
