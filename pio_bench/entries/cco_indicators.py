"""Entry ``cco_indicators``: the self-indicator of one event type from the
blocked layout, one step a train.

Set-up stages the generated events through
``ops/cco.py:block_interactions_stream`` in the traffic's batches (the
host staging of an event log too large for one array), as the scale path
does.  A step is ``cco_indicators`` of the layout against itself with the
diagonal masked: the strategy the program picks for the shape, then K2
and K3 a tile.
"""

from pio_bench import check


def prepare(cfg, traffic, events, device):
    from predictionio_tpu_torch.ops import cco

    name = cfg["event_types"][0]["name"]
    ev = events[name]
    users, items, batch = int(cfg["users"]), int(cfg["items"]), int(traffic["batch"])
    blocked = cco.block_interactions_stream(
        ((ev.user[s:s + batch], ev.item[s:s + batch]) for s in range(0, len(ev.user), batch)),
        users, items, user_block=int(cfg["user_block"]))

    def step():
        scores, ids = cco.cco_indicators(
            blocked, blocked, None, None, users, top_k=int(cfg["top_k"]),
            llr_threshold=float(cfg["min_llr"]), item_tile=int(cfg["item_tile"]),
            exclude_self=True, device=device)
        return check.Output(tables={name: (scores, ids)})

    return step
