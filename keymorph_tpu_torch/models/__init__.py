"""Backbone, keypoint head and registration pipeline of the port."""
