"""The flagship watermark codec and its payload spread codec."""

from .dwt_dct_svd import DwtDctSvd, block_grid  # noqa: F401
from .payload import DeShuffler, Shuffler, despread_mean, keyed_shuffle_indices  # noqa: F401
