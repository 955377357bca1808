"""The streams kernel (CUDA) and the dispatch between it and the
generator's sort on the CPU."""
from .ops import decoded_request_streams
from .streams import request_streams
