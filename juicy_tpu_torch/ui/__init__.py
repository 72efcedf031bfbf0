from juicy_tpu_torch.ui.meters import MeterPanel, MetricStats

__all__ = ["MeterPanel", "MetricStats"]
