"""Communication layer of the port: the channel plan values (gather / MAC
superposition / budgeted rates) and the wire's collectives on
``torch.distributed``."""
from .channel import (  # noqa: F401
    GATHER,
    BudgetChannel,
    Channel,
    GatherChannel,
    MACChannel,
)
from .collectives import (  # noqa: F401
    all_gather,
    erasure_all_gather,
    neutral_fill,
    psum,
    superposed_psum,
)
