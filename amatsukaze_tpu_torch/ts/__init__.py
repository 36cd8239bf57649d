"""Transport-stream layer: packets, PES, PSI, the splitter and its ES
parsers, the stream report (info.py) and the QP maps that feed the
deblock post filter (copies of amatsukaze_tpu/ts)."""

from .packet import TS_PACKET_LENGTH, TsPacket, TsPacketParser
from .pes import PESPacket, PesParser
from .psi import PAT, PMT, PsiParser, PsiSection
from .splitter import TsSplitter, TsSystemClock

__all__ = [
    "TS_PACKET_LENGTH",
    "TsPacket",
    "TsPacketParser",
    "PESPacket",
    "PesParser",
    "PsiParser",
    "PsiSection",
    "PAT",
    "PMT",
    "TsSplitter",
    "TsSystemClock",
]
