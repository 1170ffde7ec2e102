from .compaction import push_all_left
from .trace import (
    is_enabled,
    profile_solve,
    set_debug,
    span,
    trace_host,
    trace_round,
)
