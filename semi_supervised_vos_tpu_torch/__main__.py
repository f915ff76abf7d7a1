"""``python -m semi_supervised_vos_tpu_torch {inference,evaluation}``."""

import click

from semi_supervised_vos_tpu_torch.cli.evaluation import evaluation_command
from semi_supervised_vos_tpu_torch.cli.inference import inference_command


@click.group(name="cli")
def cli():
    pass


cli.add_command(inference_command)
cli.add_command(evaluation_command)


if __name__ == "__main__":
    cli()
