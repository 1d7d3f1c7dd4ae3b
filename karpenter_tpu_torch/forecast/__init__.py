"""karpenter_tpu_torch.forecast — arrival-rate forecasting.

The predictive half of provisioning, the port's copy of
``karpenter_tpu/forecast``: an online per-provisioner arrival model fed by
the span stream (``forecast/model.py``), consumed by the speculative
warm-pool controller (``controllers/warmpool.py``). Install the process
forecaster with ``obs.configure_forecast``; read it back with
``obs.forecaster()``.
"""

from karpenter_tpu_torch.forecast.model import (  # noqa: F401
    DEFAULT_BAND_SIGMA,
    DEFAULT_BUCKET_S,
    DEFAULT_HORIZON_S,
    MAX_HORIZON_S,
    MIN_HORIZON_S,
    MODEL_EWMA,
    MODEL_HOLT_WINTERS,
    ArrivalForecaster,
    Ewma,
    HoltWinters,
    ShardForecast,
    build_model,
)
