"""The window's host time over the training steps it completed, steps back
to back."""

def read(data):
    if data["unit"] != "step" or not data["units"]:
        return None
    return 1e3 * data["window_s"] / data["units"]
