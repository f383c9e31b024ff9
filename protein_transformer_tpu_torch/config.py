"""Typed configuration for the port (the fields the eval slice reads).

Same field names and defaults as protein_transformer_tpu/config.py;
fields come with the slices that read them. ``finalize()`` applies the
reference's derived-config rules with the port's own model factory.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from protein_transformer_tpu.protein.constants import MAX_SEQ_LEN

LOSSES = ("mse", "drmsd", "lndrmsd", "combined")


@dataclasses.dataclass
class TrainConfig:
    data: str = "data/casp12.pt"

    batch_size: int = 8
    loss: str = "combined"
    without_angle_means: bool = False
    skip_missing_res_train: bool = False
    combined_drmsd_weight: float = 0.5
    backbone_loss: bool = False
    # Under --backbone_loss every dRMSD/RMSD metric is computed on
    # backbone-reduced coordinates; full_metrics restores full-atom
    # reporting.
    full_metrics: bool = False

    # Model
    model: str = "enc-only"
    d_model: int = 512
    d_ff: int = 2048
    n_heads: int = 8
    n_layers: int = 6
    dropout: float = 0.1
    postnorm: bool = False
    conv1_size: Optional[int] = None
    conv2_size: Optional[int] = None
    conv3_size: Optional[int] = None
    conv1_reduc: Optional[float] = None
    conv2_reduc: Optional[float] = None
    conv3_reduc: Optional[float] = None
    use_embedding: bool = True
    conv_out_matches_dm: bool = True

    max_seq_len: int = MAX_SEQ_LEN
    bucket_sizes: Sequence[int] = (64, 128, 192, 256, 320, 384, 448, 512)
    # dRMSD pair sweep: cuda (hand-written kernel) | torch (plain) | auto
    # (cuda for a CUDA device, torch otherwise).
    drmsd_impl: str = "auto"

    vocab_size: int = 22
    pad_id: int = 20

    def finalize(self) -> "TrainConfig":
        """Apply the reference's derived-config rules: check the loss, and
        unpack a 'conv-enc|k1,k2|r1,r2' name into the conv fields."""
        if self.loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}")
        if "conv-enc" in self.model and "|" in self.model:
            from protein_transformer_tpu_torch.models.factory import (
                parse_conv_kernel_info_from_model_name)
            kernels, reducs = parse_conv_kernel_info_from_model_name(self.model)
            if len(kernels) > 3:
                raise ValueError("at most 3 conv layers supported")
            for i, (k, r) in enumerate(zip(kernels, reducs), start=1):
                setattr(self, f"conv{i}_size", k)
                setattr(self, f"conv{i}_reduc", r)
            suffix = "-linear-out" if "linear-out" in self.model else ""
            self.model = "conv-enc" + suffix
        return self
