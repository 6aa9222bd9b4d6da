"""Protocol data model (reference: accord/primitives — SURVEY.md §2.2)."""

from accord_tpu_torch.primitives.timestamp import (
    Timestamp, TxnId, Ballot, TxnKind, Domain, KindSet,
)
from accord_tpu_torch.primitives.keys import (
    RoutingKey, Key, Keys, RoutingKeys, Range, Ranges, Route,
)
from accord_tpu_torch.primitives.deps import KeyDeps, RangeDeps, Deps
from accord_tpu_torch.primitives.txn import Txn, PartialTxn
from accord_tpu_torch.primitives.writes import Writes
