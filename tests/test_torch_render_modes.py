"""PyTorch port, the slice as a whole, continued: the render parity of
tests/test_torch_render.py with MIS off and with the GL-faithful bilinear
environment fetches (a second file so each stays well inside a minute)."""

import pytest

from test_torch_render import check_case, scenes  # noqa: F401 (fixture)


@pytest.mark.parametrize("case", ["env_no_mis", "env_bilinear"])
def test_render_radiance_modes_match_jax(scenes, case):  # noqa: F811
    check_case(scenes, case)
