"""`python -m iivision_tpu_torch` == the transcode CLI
(iivision-torch-transcode)."""

from iivision_tpu_torch.cli import main

if __name__ == "__main__":
    main()
