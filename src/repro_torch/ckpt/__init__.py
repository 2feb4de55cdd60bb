from .checkpoint import (AsyncCheckpointer, available_steps,  # noqa: F401
                         restore_latest, save)
from .tuned_writer import TunedCheckpointWriter  # noqa: F401
