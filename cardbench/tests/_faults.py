"""Faults planted under a run's timed path, for the tests that see
``correct`` come out false."""


def frozen_frame(self, y, mask, fov, weight, x0, x_ref):
    """A frame that returns its state unchanged."""
    return x0, self._frame_image(mask, fov, weight, x0)


def altered_image(original):
    """The readout's image altered where it is produced (scaled by 1 %)."""
    def image(self, mask, fov, weight, u):
        return original(self, mask, fov, weight, u) * 1.01
    return image
