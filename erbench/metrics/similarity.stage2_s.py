"""Mean ``ERResult.extra["timings"]["stage2_s"]`` per ``run_er`` call of the
window (the program's own timer, host clock)."""


def read(record):
    runs = [r for r in record.get("runs", ()) if "error" not in r]
    if record["kind"] != "batch" or not runs:
        return None
    return sum(r["timings"]["stage2_s"] for r in runs) / len(runs)
