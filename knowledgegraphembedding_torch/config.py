"""Model and run configuration.

``ModelSpec`` is the frozen, hashable description of a KGE model (reference:
codes/model.py §KGEModel.__init__ ≈L25-100). ``RunConfig`` carries every CLI
flag of the JAX package under the same name, so a ``config.json`` written by
either package loads into the other (reference: codes/run.py §parse_args
≈L27-80, §override_config ≈L83-100).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

MODEL_NAMES = ("TransE", "DistMult", "ComplEx", "RotatE", "pRotatE")

#: Fixed epsilon used to derive the uniform init range from gamma
#: (reference: codes/model.py ≈L33 ``self.epsilon = 2.0``).
EPSILON = 2.0


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Hashable description of a KGE model.

    ``hidden_dim`` is the base dim; the doubling flags widen the stored
    tables (complex-valued models store (re, im) concatenated).
    ``embedding_range = (gamma + epsilon) / hidden_dim`` sets both the
    uniform init and the RotatE/pRotatE phase scale.
    """

    model_name: str
    nentity: int
    nrelation: int
    hidden_dim: int
    gamma: float
    double_entity_embedding: bool = False
    double_relation_embedding: bool = False

    def __post_init__(self):
        if self.model_name not in MODEL_NAMES:
            raise ValueError(f"model {self.model_name} not supported")
        # reference asserts (codes/model.py ≈L60-66)
        if self.model_name == "RotatE" and not (
            self.double_entity_embedding and not self.double_relation_embedding
        ):
            raise ValueError("RotatE should use --double_entity_embedding")
        if self.model_name == "ComplEx" and not (
            self.double_entity_embedding and self.double_relation_embedding
        ):
            raise ValueError(
                "ComplEx should use --double_entity_embedding and "
                "--double_relation_embedding"
            )

    @property
    def embedding_range(self) -> float:
        return (self.gamma + EPSILON) / self.hidden_dim

    @property
    def entity_dim(self) -> int:
        return self.hidden_dim * 2 if self.double_entity_embedding else self.hidden_dim

    @property
    def relation_dim(self) -> int:
        return (
            self.hidden_dim * 2 if self.double_relation_embedding else self.hidden_dim
        )

    @property
    def has_modulus(self) -> bool:
        """pRotatE carries an extra trainable scalar (codes/model.py ≈L52-55)."""
        return self.model_name == "pRotatE"


@dataclasses.dataclass
class RunConfig:
    """The CLI surface, field for field the JAX package's ``RunConfig``.

    Flags whose work is not ported yet are still parsed (so a saved
    ``config.json`` loads) and are refused by ``cli.main`` when set."""

    cuda: bool = False  # reference flag: run on the GPU (the default here)
    do_train: bool = False
    do_valid: bool = False
    do_test: bool = False
    evaluate_train: bool = False
    countries: bool = False
    regions: Optional[list] = None
    data_path: Optional[str] = None
    model: str = "TransE"
    double_entity_embedding: bool = False
    double_relation_embedding: bool = False
    negative_sample_size: int = 128
    hidden_dim: int = 500
    gamma: float = 12.0
    negative_adversarial_sampling: bool = False
    adversarial_temperature: float = 1.0
    batch_size: int = 1024
    regularization: float = 0.0
    test_batch_size: int = 4
    uni_weight: bool = False
    learning_rate: float = 0.0001
    cpu_num: int = 10
    init_checkpoint: Optional[str] = None
    save_path: Optional[str] = None
    max_steps: int = 100000
    warm_up_steps: Optional[int] = None
    save_checkpoint_steps: int = 10000
    valid_steps: int = 10000
    log_steps: int = 100
    test_log_steps: int = 1000
    nentity: int = 0  # filled by cli.main
    nrelation: int = 0  # filled by cli.main
    seed: int = 0
    eval_chunk_size: int = 4096  # candidate-axis chunk of the plain ranker
    num_shards: int = 1
    use_pallas: Optional[bool] = None  # the hand-written rank kernel (None = on CUDA)
    prefetch_depth: int = 4
    scoring: str = "auto"
    precision: str = "f32"
    sampler_backend: str = "auto"
    negative_sharing: str = "none"
    steps_per_dispatch: int = 1
    model_shards: int = 1
    # crc32 of the train triples, stamped at save and compared on resume
    data_fingerprint: int = 0
    async_checkpoint: bool = True
    sharded_checkpoint: bool = False
    profile_dir: Optional[str] = None
    eval_filter: str = "auto"  # 'auto' | 'host' | 'device'
    platform: str = "auto"  # 'auto' / 'gpu' = CUDA, 'cpu' = CPU
    multihost: bool = False
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    spmd_mode: str = "gspmd"

    def model_spec(self) -> ModelSpec:
        return ModelSpec(
            model_name=self.model,
            nentity=self.nentity,
            nrelation=self.nrelation,
            hidden_dim=self.hidden_dim,
            gamma=self.gamma,
            double_entity_embedding=self.double_entity_embedding,
            double_relation_embedding=self.double_relation_embedding,
        )
