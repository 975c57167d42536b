from .swf import SWFReader, SWFWriter
from .reader import Reader, WorkloadWriter
from .synthetic import SyntheticWorkload

__all__ = ["SWFReader", "SWFWriter", "Reader", "WorkloadWriter",
           "SyntheticWorkload"]
