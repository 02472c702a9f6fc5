"""The device's milliseconds a traced step in the program's
``scene.structure`` spans (the scene generator's structure block in each
G forward: the transforms from the latent, the patch noise, the affine
grid and the sampling of B x P masks); nothing where the program has no
such span."""
from portbench import spans


def read(run):
    return spans.device_ms_a_step("scene.structure")
