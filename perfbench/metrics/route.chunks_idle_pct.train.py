"""Share of the program's ``yabpe.route.chunks`` spans (K2's chunks, host syncs included) in
which no kernel, copy or memset ran on the card, from the device trace: the spans are stamped on
the trace's clock."""

from spans import idle_pct, trainings


def read(rec):
    trace = rec.get("trace")
    chunks = [(s["start_ns"], s["end_ns"]) for run in trainings(rec) or []
              for s in run["spans"] if s["name"] == "yabpe.route.chunks"]
    if not trace or not chunks:
        return None
    return idle_pct(chunks, [(s, e) for s, e, _ in trace["device"]])
