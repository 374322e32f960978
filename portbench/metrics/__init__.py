"""One reader per per-layer metric, found by the metric's name
(``<name>.py``), and the frozen map from device kernel names to layers."""
