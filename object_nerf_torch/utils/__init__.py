"""Run helpers of the train CLI: validation images and the source snapshot."""
