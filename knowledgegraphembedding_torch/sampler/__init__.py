"""Negative sampling: the host samplers with the prefetch/upload pipeline,
and the device-resident gap sampler (``device_sampler``)."""

from .negative import (  # noqa: F401
    BidirectionalIterator,
    PrefetchIterator,
    TrainSampler,
    build_train_iterator,
)
