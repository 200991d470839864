"""Configuration and device resolution."""
