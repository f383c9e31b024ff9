"""Typed configuration for the port (the fields its slices read so far).

Same field names and defaults as protein_transformer_tpu/config.py;
fields come with the slices that read them. ``finalize()`` applies the
reference's derived-config rules with the port's own model factory.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from protein_transformer_tpu_torch.protein.constants import MAX_SEQ_LEN

LOSSES = ("mse", "drmsd", "lndrmsd", "combined")
COMPUTE_DTYPES = ("float32", "bfloat16")
# The 'mla-moe' family's architecture (models/mla_moe.py): the keys of a
# published DeepSeek-V3 config.json that it reads, and the two balancing
# constants that such a config does not give: bias_update_speed (gamma of
# the aux-loss-free bias update) and seq_aux_alpha (alpha of the
# sequence-wise balance loss). The family is the published variant whose
# other keys take one value each: no query compression (q_lora_rank null),
# every layer after the dense ones an expert layer, a sigmoid router with
# noaux_tc top-k over one group, normalised top-k weights, seq_aux.
MLA_MOE_KEYS = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                "v_head_dim", "rope_theta", "first_k_dense_replace",
                "moe_intermediate_size", "n_routed_experts",
                "num_experts_per_tok", "n_shared_experts",
                "routed_scaling_factor", "rms_norm_eps", "bias_update_speed",
                "seq_aux_alpha")


@dataclasses.dataclass
class TrainConfig:
    data: str = "data/casp12.pt"
    name: Optional[str] = None

    # Training
    learning_rate: float = 1e-4
    epochs: int = 10
    batch_size: int = 8
    early_stopping: int = 20
    n_warmup_steps: int = 10_000
    clip: float = 1.0
    loss: str = "combined"
    train_only: bool = False
    lr_scheduling: str = "plateau"          # noam | plateau
    patience: int = 10
    early_stopping_threshold: float = 0.001
    early_stopping_metric: Optional[str] = None
    without_angle_means: bool = False
    eval_train: bool = False
    optimizer: str = "sgd"                   # adam | sgd
    fraction_complete_tf: float = 1.0
    fraction_subseq_tf: float = 1.0
    skip_missing_res_train: bool = False
    repeat_train: int = 1
    seed: int = 11_731
    combined_drmsd_weight: float = 0.5
    # Training-gradient semantics for dRMSD-family losses: "mean"
    # differentiates the reported batch-mean scalar; "reference" injects
    # d(sum over proteins of per-protein ln-dRMSD), plus the MSE term for
    # "combined", as the original torch code stitched its gradients.
    grad_semantics: str = "mean"
    batching_order: str = "binned-random"
    backbone_loss: bool = False
    # Under --backbone_loss every dRMSD/RMSD metric is computed on
    # backbone-reduced coordinates; full_metrics restores full-atom
    # reporting.
    full_metrics: bool = False
    bins: int = -1                           # -1 -> 'auto'
    train_eval_downsample: float = 0.10
    # probe the largest batch that fits on the device before training and
    # train at 0.8 of it (training/batch_probe.py)
    automatically_determine_batch_size: bool = False

    # Model
    model: str = "enc-only"
    d_model: int = 512
    d_ff: int = 2048
    n_heads: int = 8
    n_layers: int = 6
    dropout: float = 0.1
    postnorm: bool = False
    weight_decay: bool = True
    conv1_size: Optional[int] = None
    conv2_size: Optional[int] = None
    conv3_size: Optional[int] = None
    conv1_reduc: Optional[float] = None
    conv2_reduc: Optional[float] = None
    conv3_reduc: Optional[float] = None
    use_embedding: bool = True
    conv_out_matches_dm: bool = True
    # model 'mla-moe': {key: value} of every MLA_MOE_KEYS entry (d_model,
    # n_layers, n_heads and d_ff are the published hidden_size,
    # num_hidden_layers, num_attention_heads and intermediate_size)
    mla_moe: Optional[dict] = None

    # Saving / logging
    log_structure_step: int = 10
    log_val_struct_step: int = 50
    log_wandb_step: int = 1
    save_pngs: bool = False
    restart: bool = False
    restart_opt: bool = False
    checkpoint_time_interval: float = 0.0
    load_chkpt: Optional[str] = None
    out_dir: str = "runs"
    # Weights & Biases logging (training/wandb_logging.py), every
    # log_wandb_step train steps, and the epoch's gradient histograms
    use_wandb: bool = False
    # limited-I/O mode: no live per-batch status line, epoch prints only
    cluster: bool = False

    max_seq_len: int = MAX_SEQ_LEN
    bucket_sizes: Sequence[int] = (64, 128, 192, 256, 320, 384, 448, 512)
    # the mesh over the run's ranks (parallel/mesh.py): -1 infers an axis;
    # 'data' shards the batch rows, 'model' the attention heads and the
    # feed-forward hidden units
    mesh_shape: Sequence[int] = (-1,)
    mesh_axes: Sequence[str] = ("data",)
    # The dtype the model computes in (models/transformer.py): float32, or
    # bfloat16 with the parameters, the output head and the losses kept in
    # float32, as the JAX package's flax modules cast them.
    compute_dtype: str = "float32"           # float32 | bfloat16
    # dRMSD pair sweep and the RMSD's superposition: cuda (hand-written
    # kernels) | torch (plain) | auto (cuda for a CUDA device, torch
    # otherwise).
    drmsd_impl: str = "auto"
    # Sidechain build: cuda (hand-written kernels) | torch (plain) | auto,
    # as drmsd_impl.
    sidechain_impl: str = "auto"
    # Encoder self-attention (ops/attention.py): flash sends attention
    # without dropout on the probabilities (eval, predict, dropout-0
    # training) through the flash kernels; training with dropout > 0 keeps
    # the materialised branch. auto = xla (the materialised branch).
    attention_impl: str = "auto"             # auto | xla | flash
    # a torch.profiler trace of the first trained epoch goes here
    profile_dir: Optional[str] = None
    # Device-resident data path (data/device_store.py): splits live on the
    # device and a batch is one gather. auto = on when the footprint fits
    # device_data_max_mb.
    device_data: str = "auto"                # auto | true | false
    device_data_max_mb: int = 4096

    # Derived (filled by finalize())
    vocab_size: int = 22
    pad_id: int = 20
    es_mode: str = "train"
    es_metric: str = "combined"
    add_sos_eos: bool = False

    def finalize(self) -> "TrainConfig":
        """Apply the reference's derived-config rules: check the loss and the
        compute dtype, default the monitored metric to 'train-<loss>' and
        split it into its mode and metric, and unpack a 'conv-enc|k1,k2|
        r1,r2' name into the conv fields."""
        if self.loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}; "
                             f"got {self.compute_dtype!r}")
        if self.model == "mla-moe":
            self._check_mla_moe()
        if not self.early_stopping_metric:
            self.early_stopping_metric = f"train-{self.loss}"
        parts = self.early_stopping_metric.split("-")
        # the mode may itself contain '-' (valid-70)
        self.es_metric = parts[-1]
        self.es_mode = "-".join(parts[:-1])
        # as in the JAX package, no batch changes with it: collate adds no
        # start or end token
        self.add_sos_eos = self.model == "enc-dec"
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

    def _check_mla_moe(self) -> None:
        """The 'mla-moe' fields: every key given, the widths whole, and the
        settings the family does not take."""
        arch = self.mla_moe or {}
        missing = [k for k in MLA_MOE_KEYS if k not in arch]
        unknown = sorted(set(arch) - set(MLA_MOE_KEYS))
        if missing or unknown:
            raise ValueError(f"model 'mla-moe': mla_moe lacks {missing} "
                             f"and has unknown keys {unknown}")
        for k in ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                  "v_head_dim", "moe_intermediate_size", "n_routed_experts",
                  "num_experts_per_tok", "n_shared_experts"):
            if not isinstance(arch[k], int) or arch[k] < 1:
                raise ValueError(f"mla_moe {k} must be a positive integer; "
                                 f"got {arch[k]!r}")
        checks = (
            (arch["qk_rope_head_dim"] % 2 == 0,
             "qk_rope_head_dim must be even: RoPE rotates pairs"),
            (arch["num_experts_per_tok"] <= arch["n_routed_experts"],
             "num_experts_per_tok must not exceed n_routed_experts"),
            (0 <= arch["first_k_dense_replace"] <= self.n_layers,
             "first_k_dense_replace must lie in 0..n_layers"),
            (self.attention_impl in ("auto", "xla"),
             "attention_impl flash: the flash kernels stop at D 128 with "
             "D_v = D_qk; MLA takes the materialised branch"),
            (self.dropout == 0.0,
             "dropout must be 0.0: the family has no dropout"),
            ((self.fraction_complete_tf, self.fraction_subseq_tf) ==
             (1.0, 1.0),
             "scheduled sampling belongs to enc-dec"),
        )
        for ok, msg in checks:
            if not ok:
                raise ValueError(f"model 'mla-moe': {msg}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        """A config from a saved dict; keys that are no field of the port
        (a run of the JAX package has more) are dropped."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})
