"""masked_tree_pct.cyc on synthetic run records: the tree engine's share of
-c's masked chainings' anchors, read from each window job's
metrics.summary() counters."""

import pytest

from portbench import spec


def _job(**tags):
    dp = {"dp_cells": 10, "device_cells": 0,
          "chain.cdq": {"count": 1, "cells": 900, "seconds": 0.5}}
    for tag, cells in tags.items():
        dp["chain." + tag] = {"count": 1, "cells": cells, "seconds": 0.5}
    return {"dp": dp}


def test_masked_tree_share():
    read = spec.reader("masked_tree_pct.cyc")
    run = {"jobs": [_job(masked=400, masked_cdq=300, masked_tree=100),
                    _job(masked=600, masked_cdq=600)]}
    assert read(run) == pytest.approx(100.0 * 100 / 1000)
    assert read({"jobs": [_job(masked=5, masked_cdq=5)]}) == 0.0
    assert read({"jobs": [_job(masked=7, masked_tree=7)]}) == 100.0
    # the parent of the change that added the two tags counts masked
    # chainings under chain.masked alone: nothing to read
    assert read({"jobs": [_job(masked=400), {"dp": {}}]}) is None
    assert read({"jobs": []}) is None
