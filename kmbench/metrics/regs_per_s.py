"""Registrations completed over the window, a second: each request's
pairs aligned under one transform and warped, over the window's host time."""

def read(data):
    if "registrations" not in data or data["window_s"] <= 0:
        return None
    return data["registrations"] / data["window_s"]
