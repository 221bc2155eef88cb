"""fold_mixed_tiled against the Pallas _fold_mixed_tiled (interpret mode)
at L = 1,024 lanes, C = 4: several 512-lane tiles of the Pallas grid, the
same lane kinds as tests/test_torch_ec_tiled.py.  Exact equality."""
import torch

from test_torch_ec_tiled import check_tiled

torch.set_num_threads(1)


def test_fold_mixed_tiled_matches_pallas_l1024():
    check_tiled(1024, 62)
