"""Channel plan values (the gather channel of ``repro.comm.channel``)."""
from .channel import GATHER, Channel, GatherChannel  # noqa: F401
