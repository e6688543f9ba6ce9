"""The roofline of the port on an H100: the card's peak terms, one count
of each kernel's work, and the counter the dry run runs a rank's step
under (``launch/dryrun.py``)."""
from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS  # noqa: F401
from repro_torch.roofline.flash_model import flash_work  # noqa: F401
