"""Layers of the codec: weight-normed convs, Snake and the residual blocks."""
