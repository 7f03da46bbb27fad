"""Typed configuration schema of the PyTorch port.

A copy of ``singa_tpu/config.py`` (the port imports nothing of the JAX
package): the same dataclasses, defaults, vocabulary and YAML loader, so a
config file drives both packages identically.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import yaml

# The 116-token SMILES vocabulary (reference config/train.yml:72-189 and
# utils/PLParser.py:37-154 duplicate it; here it lives in exactly one place).
SMI_VOCAB: tuple[str, ...] = (
    "#", "$", "&", "(", ")", "-", "/", ".",
    "1", "2", "3", "4", "5", "6", "7", "8", "9", "=",
    "B", "Br", "C", "Cl", "F", "I", "N", "O", "P", "S",
    "[125I]", "[18F]", "[2H]", "[3H]", "[AlH2]", "[As]", "[Au]", "[B-]",
    "[C-]", "[C@@H]", "[C@@]", "[C@H]", "[C@]", "[CH-]", "[Cr]", "[Fe--]",
    "[Fe@@]", "[Fe@]", "[Fe]", "[Hg]", "[K]", "[Li]", "[Mg]", "[MgH2]",
    "[Mo]", "[N+]", "[N-]", "[N@+]", "[N@@+]", "[N@@]", "[N@H+]", "[N@]",
    "[NH+]", "[NH-]", "[NH2+]", "[NH3+]", "[N]", "[Na]", "[O+]", "[O-]",
    "[OH+]", "[O]", "[P+]", "[P@@]", "[P@]", "[PH]", "[P]", "[Pd]",
    "[Re]", "[Ru@@]", "[Ru]", "[S+]", "[S-]", "[S@+]", "[S@@+]", "[S@@H]",
    "[S@@]", "[S@H]", "[S@]", "[SH]", "[Sc]", "[S]", "[Sb]", "[SeH]",
    "[Se]", "[Si]", "[SnH]", "[Sn]", "[V]", "[Zn++]", "[c-]", "[n+]",
    "[n-]", "[nH+]", "[nH]", "[o+]", "[s+]", "[se]", "[V]", "[W]",
    "[Zn]", "\\", "^", "c", "n", "o", "p", "s",
)

SOS_TOKEN = SMI_VOCAB.index("&")
EOS_TOKEN = SMI_VOCAB.index("$")
PAD_TOKEN = SMI_VOCAB.index("^")


@dataclass(frozen=True)
class EmbeddingConfig:
    """Equivariant embedding (reference config/train.yml:27-49)."""

    edge_channels: int = 16
    sphere_channels: int = 16
    attn_hidden_channels: int = 128
    attn_alpha_channels: int = 32
    attn_value_channels: int = 16
    ffn_hidden_channels: int = 512
    lmax: int = 6
    mmax: int = 2
    cutoff: float = 10.0
    # reference sets 43 (train.yml:39) but embeds raw atomic numbers, which
    # exceed 43 for e.g. iodine; we size the table for the full supported range.
    max_num_elements: int = 84
    num_heads: int = 7
    num_layers: int = 3
    norm_type: str = "rms_norm_sh"
    # FFN nonlinearity (reference EF_layers.py:152-270 config axes):
    # 'gate' = GateActivation, no grid transforms (the default; kernel K2);
    # 's2' = separable S2 grid activation (the reference's shipped default,
    # configs/train_corpus.yml; kernel K4);
    # 'grid' = grid-space 3-layer MLP (use_grid_mlp, parity coverage; not
    # ported yet, the port raises).
    ffn_activation: str = "gate"
    basis_width_scalar: float = 20.0
    # training-time rematerialisation knobs of the JAX package, kept so one
    # YAML file configures both packages; the port's inference path ignores them
    remat: bool = True
    remat_policy: str = "s2"
    avg_degree: float = 23.395238876342773  # reference Embedding.py:36


@dataclass(frozen=True)
class EncoderConfig:
    """CProMG graph encoders (train.yml:55-64)."""

    hidden_channels: int = 256
    edge_channels: int = 64
    key_channels: int = 128
    num_heads: int = 4
    num_interactions: int = 6
    knn: int = 48
    knn_aa: int = 30  # second encoder, CProMG.py:330
    # 'neighbor': [B, N, 2k] neighbour-list attention (the only form the
    # port runs); 'dense' is the JAX package's [B, N, N] form
    attn_form: str = "neighbor"
    # JAX training knob (encoder-layer remat), ignored by the port
    remat: str = "auto"
    lap_dim: int = 8
    smear_stop: float = 15.0  # CProMG.py:285
    smear_stop_aa: float = 25.0  # CProMG.py:322
    ffn_hidden: int = 1024  # CProMG.py:165


@dataclass(frozen=True)
class DecoderConfig:
    """SMILES decoder (train.yml:65-70)."""

    tgt_len: int = 200
    hidden_channels: int = 256
    key_channels: int = 128
    num_heads: int = 4
    num_interactions: int = 6
    ffn_hidden: int = 1024
    vocab_size: int = len(SMI_VOCAB)


@dataclass(frozen=True)
class ModelConfig:
    featurizer_feat_dim: int = 784  # 16 channels x 49 coeffs (GAN.py:62)
    hidden_channels: int = 256
    num_props: int = 3
    props: tuple[str, ...] = ("vina_score", "qed", "sas")
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)


@dataclass(frozen=True)
class ShapeConfig:
    """Static padding buckets for a batch (new; replaces PyG dynamic batching)."""

    num_protein_nodes: int = 384
    num_ligand_nodes: int = 64
    num_pp_edges: int = 832  # ~2.2x nodes covers covalent bond graphs
    num_ll_edges: int = 160
    num_lp_edges: int = 96
    num_pl_edges: int = 96
    node_feat_dim: int = 59  # 44 elements + 7 hybridisation + charge + 7 flags
    lap_dim: int = 8
    # destination-table caps (ops/neighbors.py): max in-degree kept
    # per node. Covalent in-degree == bond count (<= 6); interaction edges are
    # capped well above the per-atom contact counts the featurizer emits.
    max_in_degree_intra: int = 8
    max_in_degree_inter: int = 24


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    beta1: float = 0.99
    beta2: float = 0.999
    weight_decay: float = 0.0
    max_grad_norm: float = float("inf")


@dataclass(frozen=True)
class SchedulerConfig:
    type: str = "plateau"
    factor: float = 0.6
    patience: int = 5
    min_lr: float = 1e-5
    warmup_iters: int = 0


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 2022
    batch_size: int = 64
    # accumulate gradients in microbatches of this size (None: monolithic)
    microbatch: int | None = 32
    max_iters: int = 3
    val_freq: int = 1000
    pos_noise_std: float = 0.1
    num_props: int = 3
    ckpt_every: int = 10000
    ckpt_after: int = 0  # the reference's >250000 gate is a bug we don't keep
    early_stop_patience: int = 20
    early_stop_delta: float = 5e-5
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    # numerics
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class GenerateConfig:
    num_beams: int = 20
    topk: int = 1
    length_penalty: float = 0.7
    max_length: int = 200
    prop: tuple[float, ...] = (1.0, 1.0, 1.0)
    # SMILES grammar + valence masking during decode (generate/grammar.py) —
    # the reference's unrealised Masking.py intent, BASELINE north star.
    grammar_mask: bool = True
    # admit '.' under the mask (multi-fragment outputs); off for ligands
    allow_dot: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    num_data: int = -1  # -1: all devices
    num_model: int = 1


@dataclass(frozen=True)
class Config:
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    shapes: ShapeConfig = field(default_factory=ShapeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    generate: GenerateConfig = field(default_factory=GenerateConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)


def _build(cls, data: Any):
    if not dataclasses.is_dataclass(cls) or not isinstance(data, dict):
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        f = fields[key]
        sub = f.type if dataclasses.is_dataclass(f.type) else None
        # resolve dataclass defaults for nested fields
        default = (
            f.default_factory() if f.default_factory is not dataclasses.MISSING else None
        )
        if dataclasses.is_dataclass(default):
            kwargs[key] = _build(type(default), value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def load_config(path: str) -> Config:
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return _build(Config, raw)


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
