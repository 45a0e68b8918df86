from .mgr import Manager
from .telemetry import (SLO_ADMISSION, SLO_CHECKS, SLO_COPY, SLO_OPLAT,
                        Telemetry)

__all__ = ["Manager", "Telemetry", "SLO_OPLAT", "SLO_COPY",
           "SLO_ADMISSION", "SLO_CHECKS"]
