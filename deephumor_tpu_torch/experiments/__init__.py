"""Inference helpers."""
