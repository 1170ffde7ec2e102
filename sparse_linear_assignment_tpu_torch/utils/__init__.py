from .trace import (
    is_enabled,
    profile_solve,
    set_debug,
    trace_host,
    trace_round,
)
