"""The paper's own model (§5): affine-linear extreme classifier
xi_y(x) = w_y^T x + b_y over XML-CNN-style features.

Dataset scales mirror Table 1 (Wikipedia-500K: N=1.6M, C=217240, K=512;
Amazon-670K: N=490k, C=213874, K=512). Auxiliary tree: k=16,
lambda_n=0.1 (paper's hyperparameters)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class XCLinearConfig:
    name: str = "xc_linear"
    feature_dim: int = 512        # K
    num_labels: int = 217_240     # C (Wikipedia-500K after preprocessing)
    gen_feature_dim: int = 16     # k (paper §5)
    gen_reg: float = 0.1          # lambda_n (paper §5)
    head_reg: float = 0.001       # lambda   (paper Table 1)
    learning_rate: float = 0.01   # rho      (paper Table 1, Adagrad)
    n_neg: int = 1


def config() -> XCLinearConfig:
    return XCLinearConfig()


def reduced() -> XCLinearConfig:
    return XCLinearConfig(feature_dim=32, num_labels=128, gen_feature_dim=8)
