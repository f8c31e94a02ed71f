"""The ported watermark codecs, the payload spread codecs and the DT-CWT
codecs' payload planes."""

from .dct_qim import DctQim  # noqa: F401
from .dtcwt_codecs import DtcwtImg, DtcwtKey, clear_wm_cache  # noqa: F401
from .dwt_dct_svd import DwtDctSvd, block_grid  # noqa: F401
from .payload import (DeGrayScale, DeShuffler, GrayScale, Shuffler, despread_mean,  # noqa: F401
                      keyed_shuffle_indices)
from .payload_img import BlockShuffler, CorrShuffler, DeBlockShuffler, DeCorrShuffler  # noqa: F401
