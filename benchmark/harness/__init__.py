"""The benchmark's machinery: specs, weights, traffic, tracing, arithmetic."""
