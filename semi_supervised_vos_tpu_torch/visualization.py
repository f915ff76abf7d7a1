"""The visualization CLI, with the surface of the repo's root
``visualization.py`` (reference ``visualization.py``) on the port's
renderers:

    python -m semi_supervised_vos_tpu_torch.visualization {overlay,side-by-side,prediction-only}
"""

import click

from semi_supervised_vos_tpu_torch.viz.render import render_overlay, render_prediction_only, render_side_by_side


@click.group(name="cli")
def cli():
    pass


@cli.command(name="overlay")
@click.option("-p", "--prediction", type=click.Path(file_okay=False, dir_okay=True), required=True,
              help="Directory containing predictions.")
@click.option("-s", "--source", type=click.Path(file_okay=False, dir_okay=True), required=True,
              help="Directory containing video frames.")
@click.option("-o", "--output", type=click.Path(file_okay=True, dir_okay=False), required=True,
              help="Path to save the output video.")
@click.option("-f", "--fps", type=click.INT, default=15, required=False,
              help="Number of frames per second in the resulting video.")
@click.option("--bw/--color", default=False, help="Should resulting video be black and white?")
def overlay_command(prediction, source, output, fps, bw):
    render_overlay(prediction, source, output, fps, bw)


@cli.command(name="side-by-side")
@click.option("-p", "--prediction", type=click.Path(file_okay=False, dir_okay=True), required=True,
              help="Directory containing predictions.")
@click.option("-s", "--source", type=click.Path(file_okay=False, dir_okay=True), required=True,
              help="Directory containing video frames.")
@click.option("-o", "--output", type=click.Path(file_okay=True, dir_okay=False), required=True,
              help="Path to save the output video.")
@click.option("-f", "--fps", type=click.INT, default=15, required=False,
              help="Number of frames per second in the resulting video.")
def side_by_side_command(prediction, source, output, fps):
    render_side_by_side(prediction, source, output, fps)


@cli.command(name="prediction-only")
@click.option("-p", "--prediction", type=click.Path(file_okay=False, dir_okay=True), required=True,
              help="Directory containing predictions.")
@click.option("-o", "--output", type=click.Path(file_okay=True, dir_okay=False), required=True,
              help="Path to save the output video.")
@click.option("-f", "--fps", type=click.INT, default=15, required=False,
              help="Number of frames per second in the resulting video.")
def prediction_only_command(prediction, output, fps):
    render_prediction_only(prediction, output, fps)


if __name__ == "__main__":
    cli()
