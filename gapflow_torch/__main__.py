"""Run a simulation from a YAML input file:
python -m gapflow_torch -i input.yaml [--device cuda]"""

from argparse import ArgumentParser

from . import Problem


def get_parser():
    parser = ArgumentParser()
    required = parser.add_argument_group("required arguments")
    required.add_argument("-i", "--input", dest="filename",
                          help="YAML input file", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; "
                             "there is no fallback to the CPU)")
    return parser


if __name__ == "__main__":
    args = get_parser().parse_args()
    problem = Problem.from_yaml(args.filename, device=args.device)
    problem.run()
