"""Entry ``ur_train``: the Universal Recommender's train, one step a train.

Set-up builds the ``URTrainingData`` that ``URDataSource.read_training``
would hand over: a user dictionary of every user, one catalog dictionary
of every item shared by the event types, and each type's (user, item,
item dictionary, time) arrays from the generator.  A step is
``URAlgorithm.train`` on it: the CCO of every event type against the
first (``ops/cco.py:cco_train_indicators``: densify, count product, K2,
K3), the seen lookup, the popularity backfill and the tables' conversion.
"""

from pio_bench import check


def prepare(cfg, traffic, events, device):
    from predictionio_tpu_torch.models.universal_recommender.engine import (
        URAlgorithm,
        URAlgorithmParams,
        URTrainingData,
    )
    from predictionio_tpu_torch.store.columnar import IdDict

    names = [t["name"] for t in cfg["event_types"]]
    users = IdDict([f"u{u}" for u in range(int(cfg["users"]))])
    catalog = IdDict([f"i{i}" for i in range(int(cfg["items"]))])
    td = URTrainingData(
        event_names=names, user_dict=users,
        interactions={n: (events[n].user, events[n].item, catalog, events[n].time)
                      for n in names},
        item_properties={})
    algo = URAlgorithm(URAlgorithmParams(
        app_name="pio_bench", event_names=names,
        max_correlators_per_item=int(cfg["top_k"]), min_llr=float(cfg["min_llr"]),
        item_tile=int(cfg["item_tile"]), user_block=int(cfg["user_block"]),
        backfill_type=cfg["backfill_type"],
        backfill_duration=f"{int(cfg['backfill_duration_s'])} seconds"), device=device)

    def step():
        model = algo.train(td)
        return check.Output(
            tables={n: (model.indicator_llr[n], model.indicator_idx[n]) for n in names},
            popularity=model.popularity,
            seen=(model.user_seen.indptr, model.user_seen.values))

    return step
