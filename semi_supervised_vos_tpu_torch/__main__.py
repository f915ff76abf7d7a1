"""``python -m semi_supervised_vos_tpu_torch {train,validation,inference,evaluation}``."""

import click

from semi_supervised_vos_tpu_torch.cli.evaluation import evaluation_command
from semi_supervised_vos_tpu_torch.cli.inference import inference_command
from semi_supervised_vos_tpu_torch.cli.train import train_command
from semi_supervised_vos_tpu_torch.cli.validation import validation_command


@click.group(name="cli")
def cli():
    pass


cli.add_command(train_command)
cli.add_command(validation_command)
cli.add_command(inference_command)
cli.add_command(evaluation_command)


if __name__ == "__main__":
    cli()
