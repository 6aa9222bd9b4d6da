"""Wire protocol (reference: accord/messages — SURVEY.md §2.4)."""

from accord_tpu_torch.messages.base import (
    MessageType, Request, Reply, TxnRequest, Callback, SimpleReply, FailureReply,
)
from accord_tpu_torch.messages.preaccept import PreAccept, PreAcceptOk, PreAcceptNack
from accord_tpu_torch.messages.accept import Accept, AcceptOk, AcceptNack
from accord_tpu_torch.messages.commit import Commit, CommitInvalidate
from accord_tpu_torch.messages.apply_msg import Apply, ApplyReply
from accord_tpu_torch.messages.invalidate_msg import BeginInvalidation, InvalidateReply
from accord_tpu_torch.messages.multi import MultiPreAccept
from accord_tpu_torch.messages.read import ReadTxnData, ReadOk, ReadNack
