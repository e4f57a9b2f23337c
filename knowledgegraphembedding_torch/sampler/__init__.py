"""Host-side negative sampling and the prefetch/upload pipeline."""

from .negative import (  # noqa: F401
    BidirectionalIterator,
    PrefetchIterator,
    TrainSampler,
    build_train_iterator,
)
