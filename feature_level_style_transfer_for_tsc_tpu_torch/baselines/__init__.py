"""The reference's comparison baselines, CoDATS and SLARDA."""

from .codats import CoDATSPipeline  # noqa: F401
from .slarda import SLARDAPipeline  # noqa: F401
