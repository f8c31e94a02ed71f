"""The ported watermark codecs, the payload spread codec and the DT-CWT key
codec's spread-spectrum plane."""

from .dct_qim import DctQim  # noqa: F401
from .dtcwt_codecs import DtcwtKey, clear_wm_cache  # noqa: F401
from .dwt_dct_svd import DwtDctSvd, block_grid  # noqa: F401
from .payload import DeShuffler, Shuffler, despread_mean, keyed_shuffle_indices  # noqa: F401
from .payload_img import CorrShuffler, DeCorrShuffler  # noqa: F401
