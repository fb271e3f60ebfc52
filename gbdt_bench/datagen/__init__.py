"""Data generators, one module a configuration's ``generator`` names: each
has ``make(config, seed, device) -> (X, y, X_test, y_test)``, the features
f32 tensors made on ``device`` from ``seed`` and the labels 0/1 f64."""
