"""Models of the port: the ``gat`` generator and the ``global``
discriminator."""

from grouptraj_torch.models.discriminator import (  # noqa: F401
    TrajectoryDiscriminator,
)
from grouptraj_torch.models.generator import (  # noqa: F401
    TrajectoryGenerator, sample_noises,
)
