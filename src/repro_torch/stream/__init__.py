"""repro_torch.stream — incremental and windowed MapReduce over
continuous sources.

The batch stack is reused wholesale; this package adds only the *delta*
machinery: :class:`~repro_torch.stream.source.ContinuousSource` polls a
``DataSource`` for newly arrived splits (monotone split sets, one epoch
per poll, pinned pack geometry so every epoch has the same shapes);
:class:`~repro_torch.stream.incremental.IncrementalQuery` runs each
epoch's delta through the same plan suffix and folds the keyed result
into the persisted aggregate shard by shard under the manifest-declared
monoid — update cost scales with the delta, not the history;
:class:`~repro_torch.stream.windows.WindowedQuery` keeps a ring of
per-epoch partials for tumbling/sliding windows with cache-native
eviction; and :class:`~repro_torch.stream.live.LiveQuery` drives
refreshes from a background thread so a tenant ``Session`` can
``follow()`` the stream.
"""
from repro_torch.stream.incremental import (FoldEngine, IncrementalQuery,
                                            StreamUpdate)
from repro_torch.stream.live import LiveQuery
from repro_torch.stream.source import ContinuousSource, EpochBatch
from repro_torch.stream.windows import WindowedQuery

__all__ = [
    "ContinuousSource", "EpochBatch", "FoldEngine", "IncrementalQuery",
    "LiveQuery", "StreamUpdate", "WindowedQuery",
]
