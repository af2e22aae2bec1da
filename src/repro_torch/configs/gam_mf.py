"""The paper's own model: matrix factorisation latent factors (k=10) fed to
the GAM sparse mapping (ternary tessellation + parse-tree permutation)."""
from repro_torch.core.mapping import GamConfig
from repro_torch.factorization.mf import MfConfig

MF = MfConfig(k=10, lr=0.005, epochs=25)
GAM = GamConfig(k=10, scheme="parse_tree", threshold=0.2)
MIN_OVERLAP = 2
