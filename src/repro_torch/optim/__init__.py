"""The optimizer (`repro/optim`): AdamW, global-norm clipping, the cosine
schedule and int8 gradient compression over the reference's tree."""
from .adamw import (AdamWState, adamw_init, adamw_update, clip_by_global_norm,
                    cosine_schedule)
from .compress import compress_decompress, int8_compress, int8_decompress
