"""The ported watermark codecs and the payload spread codec."""

from .dct_qim import DctQim  # noqa: F401
from .dwt_dct_svd import DwtDctSvd, block_grid  # noqa: F401
from .payload import DeShuffler, Shuffler, despread_mean, keyed_shuffle_indices  # noqa: F401
