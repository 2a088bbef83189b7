"""keep_share (%, program counter): documents the screen kept over
arrivals, from the program's pipeline counters read once after the
window (``Engine.device_counters``; cumulative since the engine began)."""


def read(rec):
    c = rec.get("counters")
    if not c or not c["arrivals"]:
        return None
    return 100.0 * c["admitted"] / c["arrivals"]
