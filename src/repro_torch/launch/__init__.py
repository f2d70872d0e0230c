"""Entry points of the port: LM serving, and the trial and host meshes on
``torch.distributed``."""
from .mesh import init_rank, make_host_mesh, make_trial_mesh  # noqa: F401
