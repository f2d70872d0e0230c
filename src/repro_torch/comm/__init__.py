"""Channel plan values (gather / MAC superposition / budgeted rates, the
plan half of ``repro.comm.channel``)."""
from .channel import (  # noqa: F401
    GATHER,
    BudgetChannel,
    Channel,
    GatherChannel,
    MACChannel,
)
