"""Communication layer of the port: the channel plan values (gather / MAC
superposition / budgeted rates) and the wire's collectives on
``torch.distributed``, the compressed gradient collectives included."""
from .channel import (  # noqa: F401
    GATHER,
    BudgetChannel,
    Channel,
    GatherChannel,
    MACChannel,
)
from .collectives import (  # noqa: F401
    all_gather,
    compressed_pmean,
    compressed_pmean_1stage,
    compressed_psum,
    dequantize_tensor,
    erasure_all_gather,
    error_feedback_apply,
    error_feedback_init,
    neutral_fill,
    psum,
    quantize_tensor,
    superposed_psum,
)
