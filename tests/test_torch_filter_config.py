"""The paper's filter application config (`repro_torch.configs.
refmlm_filter`) equals the reference's, field for field."""
import dataclasses

from repro.configs import refmlm_filter as ref
from repro_torch.configs import refmlm_filter


def test_filter_config_equals_the_reference():
    assert dataclasses.asdict(refmlm_filter.CONFIG) == dataclasses.asdict(ref.CONFIG)
    assert [f.name for f in dataclasses.fields(refmlm_filter.FilterConfig)] == \
        [f.name for f in dataclasses.fields(ref.FilterConfig)]
    assert dataclasses.is_dataclass(refmlm_filter.CONFIG)
    assert refmlm_filter.FilterConfig.__dataclass_params__.frozen
