"""Model evaluation: per-sample metrics, timing, aggregation, reports."""
