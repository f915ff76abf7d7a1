"""`evaluation` command (reference ``src/evaluation.py:39-44``)."""

from __future__ import annotations

import click

from semi_supervised_vos_tpu_torch.eval.evaluation import evaluation_command_impl


@click.command(name="evaluation")
@click.option("--ground_truth", "-g", type=click.Path(file_okay=False, dir_okay=True), required=True,
              help="Path to ground truth dataset folder.")
@click.option("--computed_results", "-c", type=click.Path(file_okay=False, dir_okay=True), required=True,
              help="Path to computed results.")
@click.option("--match-ids", is_flag=True, default=False,
              help="Pair GT/prediction objects by identical palette value "
                   "(unmatched ids score 0) instead of the reference's "
                   "zip-of-sorted-palettes pairing.")
@click.option("--processes", type=int, default=None, help="Worker processes (default: all cores).")
def evaluation_command(ground_truth, computed_results, match_ids, processes):
    evaluation_command_impl(ground_truth, computed_results, processes=processes, match_ids=match_ids)
