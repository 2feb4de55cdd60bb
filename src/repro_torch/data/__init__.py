from .pipeline import (FetchStats, MemmapSource, SyntheticSource,  # noqa: F401
                       TunedFetcher, batches)
