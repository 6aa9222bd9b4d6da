"""Integration SPI — the framework's ports (reference: accord/api — SURVEY.md §2.1).

Everything a host embeds or replaces: storage, networking, scheduling, the data
plane (query language), configuration/topology feed, liveness, callbacks.
"""

from accord_tpu_torch.api.data import Data, Read, Write, Update, Query, Result
from accord_tpu_torch.api.spi import (
    Agent, MessageSink, ConfigurationService, DataStore, ProgressLog,
    Scheduler, TopologySorter, EventsListener, LocalConfig, EpochReady,
)
