"""chain_tree_pct, both forms, on synthetic run records: the tree engine's
share of the SparseAffine-chained anchors, read from each window job's
metrics.summary() counters."""

import pytest

from portbench import spec


def _job(**tags):
    dp = {"dp_cells": 10, "device_cells": 0}
    for tag, cells in tags.items():
        dp[tag.replace("_", ".", 1)] = {"count": 1, "cells": cells,
                                         "seconds": 0.5}
    return {"dp": dp}


@pytest.mark.parametrize("form", ["chain_tree_pct.pair",
                                  "chain_tree_pct.msa"])
def test_chain_tree_share(form):
    read = spec.reader(form)
    run = {"jobs": [_job(chain_cdq=300, chain_tree=100),
                    _job(chain_cdq=500, chain_tree_fallback=100)]}
    assert read(run) == pytest.approx(100.0 * 200 / 1000)
    assert read({"jobs": [_job(chain_cdq=400), _job(chain_cdq=600)]}) == 0.0
    assert read({"jobs": [_job(chain_tree=7)]}) == 100.0
    # a program without the counters (the parent of the change that added
    # them) gives nothing to read
    assert read({"jobs": [_job(), {"dp": {}}]}) is None
    assert read({"jobs": []}) is None
