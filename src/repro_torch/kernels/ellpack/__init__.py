"""The ELLPACK packing kernel (CUDA), its plain PyTorch versions, and the
dispatch and storage report built on them."""
from .ellpack import ellpack_pack
from .ops import pack_ellpack, pack_with_report
from .ref import ellpack_pack_plain, ellpack_pack_reference
