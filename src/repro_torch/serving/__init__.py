from .serve_step import make_prefill_step, make_decode_step, greedy_generate
from .batcher import RequestBatcher, Request

__all__ = ["make_prefill_step", "make_decode_step", "greedy_generate",
           "RequestBatcher", "Request"]
